"""lets_face_it_tpu_torch — the PyTorch/CUDA port of ``lets_face_it_tpu``.

The port runs on an NVIDIA Hopper GPU (``sm_90a``). It carries the serving
path of the paper's ``final_model`` (offline generation,
``sample.generate.Generator``, and live streaming,
``sample.streaming.StreamingGenerator``), its training path
(``train.loop.train``, ``python -m lets_face_it_tpu_torch.train``), and the
render service and study-stimulus path (``render/``, with the FLAME decoder
on the card and ``python -m lets_face_it_tpu_torch.render.server``;
``data_segments/``; ``stimulus``), and the feature extraction that makes
the trainer's data (``features/``, ``python -m
lets_face_it_tpu_torch.extract_features``). The four
Pallas kernels of the JAX package are hand-written CUDA C++ here
(``csrc/``), built with ``nvcc`` at first use and bound through ``ctypes``
(``ops/flow_kernels.py`` for sampling, ``ops/train_kernels.py`` for the
training pair, wired as a ``torch.autograd.Function``).

Module paths mirror the JAX package's. The port imports neither JAX nor
anything from ``lets_face_it_tpu``; it keeps its own copies of the pure-Python
pieces it needs.
"""

__version__ = "0.1.0"
