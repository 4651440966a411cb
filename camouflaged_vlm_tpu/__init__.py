"""camouflaged_vlm_tpu — open-vocabulary camouflaged object segmentation
(OVCOS) in JAX.

A ground-up JAX/XLA re-design of the cascaded vision-language pipeline from
`intcomp/camouflaged-vlm` (arXiv 2506.19300):

  * stage 1: a prompt-tuned SAM ViT-H with an edge-aware mask decoder segments
    the camouflaged object, conditioned on CLIP image/text features;
  * stage 2: an Alpha-CLIP (MaPLe multi-modal prompt-learned) ViT-L/14@336
    recognises the open-vocabulary class, taking the stage-1 mask through its
    alpha channel.

Design stance:
  * channel-last (NHWC) layouts everywhere, static shapes, one `jit` program
    per pipeline so nothing round-trips through host memory;
  * bf16 matmuls with fp32 layer norms / softmax / logits;
  * the 4096-token global ViT blocks attend without materialising the
    decomposed relative-position bias (a Pallas-Triton kernel on NVIDIA GPUs);
  * parallelism via `jax.sharding.Mesh` (data + tensor axes) —
    collectives are compiled into the program by XLA.
"""

__version__ = "0.1.0"
