"""Config system: the reference's yaml schema, without yacs.

The port keeps its own copy of the JAX package's attribute tree
(``udp_pose_tpu/config``), so a yaml written for either package loads in
both.  See :mod:`.node`.
"""

from .node import Node, default_config, load_config, update_config

__all__ = ["Node", "load_config", "default_config", "update_config"]
