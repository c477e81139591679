"""Weight bridge between the JAX parameter tree and the port.

:func:`from_jax_numpy` takes the tree ``repro.models.init_params`` returns,
already turned into numpy arrays by the caller (``jax.tree.map(np.asarray,
params)``), and builds the port's :class:`~repro_torch.models.model.
Transformer`.  The reference stacks each scan stage's leaves on a leading
``layers`` axis; the bridge unstacks every stage, in order, into one block
per layer.  A ``group`` stage's ``b<j>`` subtrees are stacked over its
repeats; they unstack into the blocks of each repeat in turn, as
``forward`` runs them, and the shared attention block (the reference's
top-level ``shared``) crosses once, as ``Transformer.shared``.  A nested
subtree of a block (the MoE FFN's ``shared`` experts) crosses as a nested
dict.  :func:`to_jax_numpy` is the inverse, restacking each stage, so a
round trip is bit-exact.

A packed model (the reference's ``quantize_for_serving`` tree) crosses
too.  Each ``PackedWeight`` leaf travels as a plain dict ``{"packed",
"scale", "k", "n", "w_bits"}`` that the caller builds from the JAX
object; in a scan stage ``packed`` is stacked (L, K // fw, N) and
``scale`` (L, N), and the bridge unstacks them into one
:class:`~repro_torch.kernels.ops.PackedWeight` per layer.

:func:`vision_from_jax_numpy` and :func:`vision_to_jax_numpy` do the same
for the flat parameter dict of a quantized CNN (``models/vision.py``),
whose leaves are raw tensors or packed-leaf dicts.

No function here imports JAX.  bfloat16 leaves travel as their 16-bit
patterns (numpy has no bfloat16 of its own); on the way back they come out
as ``ml_dtypes.bfloat16``, the type JAX hands out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import PackedWeight
from repro_torch.models.common import require_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Transformer, _stages


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaf(v, dev, i=None):
    """A tensor, a PackedWeight from a packed-leaf dict, or a subtree's
    dict of them; ``i`` picks layer ``i`` of a scan-stacked leaf."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if isinstance(v, dict) and "packed" in v:      # not a subtree
        return PackedWeight(_to_tensor(pick(v["packed"]), dev),
                            _to_tensor(pick(v["scale"]), dev), v["k"],
                            v["n"], v["w_bits"])
    if isinstance(v, dict):
        return {k: _leaf(u, dev, i) for k, u in v.items()}
    return _to_tensor(pick(v), dev)


def _packed_dict(pws) -> dict:
    """The packed-leaf dict of one PackedWeight, or of a stage's layers
    (stacked on a leading axis)."""
    one = isinstance(pws, PackedWeight)
    pws = [pws] if one else pws
    packed = [_to_numpy(p.packed) for p in pws]
    scale = [_to_numpy(p.scale) for p in pws]
    return {"packed": packed[0] if one else np.stack(packed),
            "scale": scale[0] if one else np.stack(scale),
            "k": pws[0].k, "n": pws[0].n, "w_bits": pws[0].w_bits}


def from_jax_numpy(cfg: ArchConfig, tree: dict, device="cuda") -> Transformer:
    """The port's parameters from a numpy copy of the JAX tree (raw, or
    packed with packed-leaf dicts)."""
    dev = require_device(device)
    blocks = []
    for stage, st in zip(tree["stages"], _stages(cfg), strict=True):
        for i in range(st.repeats):
            for j, kind in enumerate(st.kinds):
                if kind != "shared_attn":
                    blocks.append(_leaf(stage[f"b{j}"] if st.group
                                        else stage, dev, i))
    leaves = {"embed": _to_tensor(tree["embed"], dev), "blocks": blocks,
              "final_norm": {k: _to_tensor(v, dev)
                             for k, v in tree["final_norm"].items()},
              "lm_head": _leaf(tree["lm_head"], dev)}
    if "shared" in tree:
        leaves["shared"] = _leaf(tree["shared"], dev)
    return Transformer(cfg, leaves)


def _stacked(layers):
    """One stage's layers of a leaf (or of a subtree) restacked on the
    leading ``layers`` axis."""
    if isinstance(layers[0], dict):
        return {k: _stacked([b[k] for b in layers]) for k in layers[0]}
    if isinstance(layers[0], PackedWeight):
        return _packed_dict(layers)
    return np.stack([_to_numpy(v) for v in layers])


def to_jax_numpy(cfg: ArchConfig, params: Transformer) -> dict:
    """The inverse of :func:`from_jax_numpy`: the JAX tree layout, one
    entry of ``stages`` a scan stage, each block leaf restacked on the
    leading ``layers`` axis."""
    t = params.tree()
    blocks, stages = iter(t["blocks"]), []
    for st in _stages(cfg):
        own = [j for j, kind in enumerate(st.kinds) if kind != "shared_attn"]
        layers = [{j: next(blocks) for j in own} for _ in range(st.repeats)]
        if st.group:
            stages.append({f"b{j}": _stacked([rep[j] for rep in layers])
                           for j in own})
        else:
            stages.append(_stacked([rep[0] for rep in layers]) if own
                          else {})
    head = t["lm_head"]
    out = {"embed": _to_numpy(t["embed"]), "stages": stages}
    if "shared" in t:
        out["shared"] = _unstacked(t["shared"])
    out["final_norm"] = {k: _to_numpy(v) for k, v in t["final_norm"].items()}
    out["lm_head"] = (_packed_dict(head) if isinstance(head, PackedWeight)
                      else _to_numpy(head))
    return out


def _unstacked(tree):
    """A block's tree of one layer (the shared block) as numpy leaves."""
    if isinstance(tree, dict):
        return {k: _unstacked(v) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return _packed_dict(tree)
    return _to_numpy(tree)


def vision_from_jax_numpy(tree: dict, device="cuda") -> dict:
    """A CNN's flat parameter dict (``models/vision.py``) from a numpy
    copy of the JAX one: raw arrays become tensors, packed-leaf dicts
    :class:`PackedWeight` leaves."""
    dev = require_device(device)
    return {k: _leaf(v, dev) for k, v in tree.items()}


def vision_to_jax_numpy(params: dict) -> dict:
    """The inverse of :func:`vision_from_jax_numpy`."""
    return {k: _packed_dict(v) if isinstance(v, PackedWeight)
            else _to_numpy(v) for k, v in params.items()}
