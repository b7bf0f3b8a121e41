"""consul_tpu_torch: the PyTorch/CUDA port of consul-tpu's simulation core.

The JAX package ``consul_tpu`` is the reference; this package mirrors its
module paths (``consul_tpu_torch/models/swim.py`` is the counterpart of
``consul_tpu/models/swim.py``) and imports nothing from it. Entry points
run on the CUDA card by default; pass ``device="cpu", kernel="torch"``
to run the plain PyTorch path on the CPU.
"""
