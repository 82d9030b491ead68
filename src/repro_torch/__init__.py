"""PyTorch/CUDA port of the streaming-graph ingestion system.

Mirrors the JAX package `repro` module for module: the same names
under the same paths, so each counterpart is found by its path.  The
port imports `torch` and numpy only, never `jax` and nothing of
`repro`; host-only modules it needs are kept here as its own copies.

Conventions:
  * node and edge keys are `torch.int64` tensors holding the uint64 bit
    pattern of the reference's x64 keys, or `torch.int32` tensors holding
    the uint32 bits of its default keys, chosen by `key_dtype=` where a
    store, sketch or edge table is made (0 = empty slot, all-ones =
    sentinel); unsigned order is taken on sign-flipped values
    (`core.compression.flip_sign`);
  * entry points take a `device` argument that defaults to "cuda" and
    fail without a card unless the caller asks for "cpu";
  * each hand-written CUDA kernel sits beside its plain PyTorch version
    (`kernels/`): a CUDA tensor launches the kernel, a CPU tensor runs
    the plain version.
"""
