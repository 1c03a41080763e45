"""The port's ops. Importing the package registers the dispatcher ops that
the models' graphs call (``torch.ops.vjepa2.flash_fwd_dn``,
``flash_fwd_bhnd``, ``ln_qkv`` and ``ln_mlp``, each with its fake kernel),
which a saved `torch.export` program needs before it loads (`hub.export`)."""

from vjepa2_tpu_torch.ops import flash_attention, flash_attention_dn, ln_mlp, ln_qkv  # noqa: F401
