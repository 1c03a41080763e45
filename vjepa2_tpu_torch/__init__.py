"""vjepa2_tpu_torch: the PyTorch and CUDA port of vjepa2_tpu, for one NVIDIA H100.

The JAX package ``vjepa2_tpu`` stays the reference; this package mirrors its
module layout (``ops``, ``models``, ``masks``, ``core``, ``train``, ``hub``,
``evals``) and never imports jax or anything of ``vjepa2_tpu``. Plain tensor
code is PyTorch; each TPU kernel on a ported path is a hand-written Hopper
kernel under ``csrc/``, built by ``_build`` at first use. Ported so far: the
frozen-encoder forward and the attentive-probe classifier, and the
masked-pretrain train step, with the DN flash-attention forward (B1) and
backward (B2).
"""
