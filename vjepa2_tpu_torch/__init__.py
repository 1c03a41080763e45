"""vjepa2_tpu_torch: the PyTorch and CUDA port of vjepa2_tpu, for one NVIDIA H100.

The JAX package ``vjepa2_tpu`` stays the reference; this package mirrors its
module layout (``ops``, ``models``, ``masks``, ``core``, ``train``, ``data``,
``cli``, ``hub``, ``evals``, ``planning``) and never imports jax or anything of
``vjepa2_tpu``. Plain tensor code is PyTorch; each TPU kernel on a ported
path is a hand-written Hopper kernel under ``csrc/``, built by ``_build`` at
first use. Ported so far: the frozen-encoder forward and the attentive-probe
classifier, the masked-pretrain train step (unfused and with the fused
LayerNorm prologues, remat policies, gradient accumulation, multi-fpc), and
the pretraining loop (``train.loop.Pretrainer``, ``cli.main``), V-JEPA 2-AC
post-training (``train.droid_loop.DroidTrainer``), CEM planning over the
AC world model (``planning``, ``hub.vjepa2_ac_vit_giant``), and the frozen
evals (``evals``, ``cli.eval``: probe grids for video and image
classification and EK100 anticipation), with every TPU kernel of the JAX
package (B1-B8).
"""
