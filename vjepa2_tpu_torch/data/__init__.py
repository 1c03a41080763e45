"""Host-side data (counterpart of `vjepa2_tpu/data`): video manifests read from
disk (`video_dataset`, `video`, `native`), their transforms and augmentations
(`transforms`, `augment`), the samplers, the spawned-worker loader and its
dispatcher (`samplers`, `loader`, `manager`), synthetic clips, and the
prefetch to the card (`prefetch`). Importing any of them initialises no CUDA
and builds nothing: the native library is built at first use."""
