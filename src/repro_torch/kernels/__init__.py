"""Hand-written CUDA kernels of the port, with wrappers and plain versions.

* :mod:`.flash_attention` — causal flash forward (fresh prefill chunks);
  replaces the Pallas ``_flash_kernel``.
* :mod:`.paged_flash_decode` — flash partials read through the page
  table (decode and resumed chunks); replaces the Pallas fp body
  ``_gqa_page_kernel``.

Sources live in ``csrc/`` and are compiled by :mod:`._build` on first
use.  Importing this package compiles nothing.
"""
