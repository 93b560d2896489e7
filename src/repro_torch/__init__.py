"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Module names and structure follow ``repro`` so each counterpart is easy to
find. The port imports ``torch``, numpy and scipy, never ``jax`` and never
``repro``. Entry points run on ``cuda`` unless the caller asks for
``cpu``; without a card they raise (`device.resolve_device`)."""
