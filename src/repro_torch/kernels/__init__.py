"""Hand-written CUDA kernels of the port, with wrappers and plain versions.

* :mod:`.flash_attention` — causal flash forward (fresh prefill chunks);
  replaces the Pallas ``_flash_kernel``.
* :mod:`.paged_flash_decode` — flash partials read through the page
  table (decode and resumed chunks); replaces the Pallas fp body
  ``_gqa_page_kernel``, and, for MLA's absorbed decode against the
  latent pool, the body ``_mla_page_kernel``.
* :mod:`.mpq_matmul` — packed sub-byte matmuls, weight-only and integer
  (every ``dense`` of a packed model); replace the Pallas ``_wo_kernel``
  and ``_int_kernel``.  :mod:`.ops` prepares the weights and calls them.

Sources live in ``csrc/`` and are compiled by :mod:`._build` on first
use.  Importing this package compiles nothing.
"""
from repro_torch.kernels.ops import (PackedWeight, prepare_weight,
                                     quantized_matmul)

__all__ = ["PackedWeight", "prepare_weight", "quantized_matmul"]
