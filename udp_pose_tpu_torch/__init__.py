"""udp_pose_tpu_torch: the PyTorch + CUDA port of ``udp_pose_tpu``.

Same module layout as the JAX package, so each module's counterpart is
easy to find; PyTorch idiom inside (``nn.Module`` in NCHW, eager ops,
``torch.inference_mode`` on the serving path).  The JAX package is the
reference this port is tested against; nothing here imports it.

Entry points: ``python -m udp_pose_tpu_torch.serve`` (``/v1/pose``, and
``/v1/detect_pose`` with ``--detector``), ``.infer`` (detect-then-pose on
images, videos and streams), ``.train`` and ``.test`` (training and
evaluation on COCO-format data).
Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
card it raises unless the caller asked for ``device="cpu"``.  The one
TPU kernel of the serving path (the UDP peak + offset decode) is a CUDA
kernel written for Hopper (``csrc/peak_offset.cu``); on a CUDA tensor it
launches or raises, and only a CPU tensor takes its plain PyTorch twin.
"""
