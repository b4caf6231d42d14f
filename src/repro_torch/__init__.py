"""PyTorch / CUDA port of the ``repro`` serve path, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``repro_torch/models/attention.py`` is the counterpart of
``repro/models/attention.py``) and imports ``torch``, never ``jax`` and
nothing of ``repro``.  This slice serves dense GQA decoders
(``llama3.2-3b`` and kin) through chunked prefill, continuous batching and
the paged KV pool; the split-K page combine runs as the hand-written Hopper
kernel in ``kernels/csrc/moa_reduce.cu``.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device they raise instead of falling back.
"""
