"""Engine exception taxonomy (port of ``udp_pose_tpu/engine/errors.py``).

``EngineStateError`` marks caller-resolvable serving states (endpoint not
available, batcher shut down) so the HTTP layer answers 409 for them and
500 for real failures such as a CUDA error, which is a ``RuntimeError``
too.
"""


class EngineStateError(RuntimeError):
    """Serving-state condition the caller can resolve (409, not 500)."""
