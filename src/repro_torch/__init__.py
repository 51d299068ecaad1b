"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The layout mirrors ``repro`` module for module (``core``, ``embed``,
``kernels/<name>/{kernel,ops,ref}.py``, ``nn``, ``models``, ``configs``,
``serve``), so each port sits beside the reference it is held against.  The
package imports torch and numpy only; hand-written CUDA C++ kernels live in
``csrc/`` and are compiled with ``nvcc`` at first use (``kernels/build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (``repro_torch.device``).
"""
