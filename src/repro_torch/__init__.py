"""PyTorch/CUDA port of the serving stack, beside the JAX reference.

The JAX package (``repro``) stays the reference; this package serves the
same ``ModelSpec`` through the same unified token-packed paged engine on an
NVIDIA H100, with every Pallas kernel on that path replaced by a kernel
written by hand for Hopper (``csrc/``).  Module names mirror the JAX
package so each counterpart is easy to find:

    repro_torch.core.modelspec      <- repro.core.modelspec
    repro_torch.configs             <- repro.configs (the served archs)
    repro_torch.kernels.ref / ops   <- repro.kernels.ref / ops
    repro_torch.kernels.ragged_attention  <- the Pallas ``_ragged_kernel``
    repro_torch.kernels.paged_decode_attention, .flash_attention,
    .expert_gemm                    <- the Pallas decode, flash and
                                       expert-GEMM kernels
    repro_torch.models.*            <- repro.models.* (packed paged path)
    repro_torch.serving.*           <- repro.serving.* (unified engine)
    repro_torch.launch.serve        <- repro.launch.serve

It imports ``torch`` and numpy only, never ``jax`` nor anything of
``repro``.  Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""
