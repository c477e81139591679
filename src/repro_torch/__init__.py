"""PyTorch/CUDA port of the ``repro`` serving stack, for one NVIDIA H100.

The layout mirrors the JAX package module by module (``repro_torch.models
.attention`` is the counterpart of ``repro.models.attention``, and so on).
The port imports ``torch`` and numpy only; it shares no code with the JAX
package, which stays the reference its tests compare against.

The port serves greedy paged requests of a dense GQA decoder
(``attn_mlp`` blocks) through :class:`repro_torch.serve.ServingEngine`.
Attention runs two hand-written CUDA kernels for ``sm_90a``
(:mod:`repro_torch.kernels`): the causal flash forward for fresh prefill
chunks and the paged flash-decode partials for decode and resumed chunks.
With weights packed by ``models.model.quantize_for_serving`` (int8/4/2,
the format on ``ArchConfig.quant``), every ``dense`` runs one of two
more: the weight-only or the integer packed matmul.

Entry points take an explicit ``device`` and default to ``"cuda"``; with
no card present they raise instead of running on the CPU.  The tests pass
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version.
"""
