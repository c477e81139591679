"""Source rules of the port's CUDA kernels, checked on the CPU.

The card is needed to run a kernel, not to read one: these tests follow
the calls from each kernel entry through the sources and their headers,
so that the bf16 routes provably reach a tensor-core instruction and an
asynchronous copy, the float32 routes stay on the CUDA cores, and no port
file reaches a library kernel.  The paged GQA kernel's bf16 routes, the
decode route (<= 16 query rows, one key tile at a time) and the chunk
route, run on the tensor cores on fp, int8 and int4 pools (a quantized
pool's raw rows widened to bf16 in shared memory); its float32 routes
keep the CUDA-core tile of ``flash_tile.cuh``.  The MLA decode
kernel's bf16 route runs its scores and context on the tensor cores from
one key tile, on fp, int8 and int4 latent pools; its float32 route
stays on FMA.  The integer matmul, whose int32 sums are exact in any
order, runs on the s8 tensor-core product."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mpq_matmul as mm
from repro_torch.kernels import paged_flash_decode as pfd

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
CSRC = _build.CSRC

MMA_BF16 = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
MMA_S8 = "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"
CALL = re.compile(r"\b(\w+)\s*(?:<[^<>;(){}]*>)?\s*(?:<<<[^>]*>>>)?\s*\(")
INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)
# statements that look like calls: ``for (...) {`` is a loop, not a
# function named ``for``, and its body is part of the caller's
KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "constexpr"}


def _includes(name):
    """Every local header a source reaches, transitively."""
    seen, todo = set(), [name]
    while todo:
        for inc in INCLUDE.findall((CSRC / todo.pop()).read_text()):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return seen


def _text(source):
    """A source with every local header it reaches."""
    return "\n".join((CSRC / f).read_text()
                     for f in [source, *sorted(_includes(source))])


def _match(text, i, open_, close):
    depth = 0
    for j in range(i, len(text)):
        depth += {open_: 1, close: -1}.get(text[j], 0)
        if depth == 0:
            return j
    raise ValueError("unbalanced")


def _body(text, name):
    """The body of the function ``name`` is defined with, or None."""
    for m in re.finditer(rf"\b{name}\s*\(", text):
        end = _match(text, m.end() - 1, "(", ")")
        rest = text[end + 1:]
        stripped = rest.lstrip()
        if stripped.startswith("{"):
            start = end + 1 + len(rest) - len(stripped)
            return text[start:_match(text, start, "{", "}") + 1]
    return None


def _reach(text, name):
    """Functions defined in ``text`` that ``name`` calls, transitively
    (kernel launches included), and ``name`` itself."""
    seen, todo = {name}, [name]
    while todo:
        body = _body(text, todo.pop()) or ""
        for callee in CALL.findall(body):
            if callee not in seen and callee not in KEYWORDS and \
                    _body(text, callee) is not None:
                seen.add(callee)
                todo.append(callee)
    return seen


@pytest.mark.parametrize("source,entry,kernel", [
    ("flash_attention.cu", "launch_mma", "flash_fwd_mma"),
    ("mpq_matmul.cu", "launch_wo_mma", "wo_mma_rows"),
    ("mpq_matmul.cu", "launch_wo_mma", "wo_mma_cols"),
    ("paged_flash_decode.cu", "launch_mma", "paged_partials_mma"),
    ("paged_flash_decode.cu", "dispatch_quant", "paged_partials_mma"),
    ("paged_flash_decode.cu", "launch_decode", "paged_decode_mma"),
    ("paged_flash_decode.cu", "dispatch_quant", "paged_decode_mma"),
    ("mla_paged_decode.cu", "mla_paged_decode_partials", "mla_partials_mma"),
    ("mla_paged_decode.cu", "mla_paged_decode_partials_quant",
     "mla_partials_mma"),
])
def test_bf16_routes_reach_tensor_cores_and_async_copies(source, entry,
                                                         kernel):
    text = _text(source)
    assert kernel in _reach(text, entry)
    reached = _reach(text, kernel)
    assert {"mma_bf16", "cp_async16", "cp_async_wait"} <= reached, reached
    assert MMA_BF16 in _body(text, "mma_bf16")
    assert "cp.async.cg.shared.global" in _body(text, "cp_async16")
    assert "ldmatrix.sync.aligned" in _body(text, "ldsm_x4")


@pytest.mark.parametrize("kernel", ["int_mma_rows", "int_mma_cols"])
def test_the_integer_routes_reach_s8_tensor_cores_and_async_copies(kernel):
    text = _text("mpq_matmul.cu")
    assert kernel in _reach(text, "launch_int")
    reached = _reach(text, kernel)
    assert {"mma_s8", "cp_async16", "cp_async_wait", "ldsm_x4",
            "ldsm_x4_t"} <= reached, reached
    assert MMA_S8 in _body(text, "mma_s8")
    assert "mma_bf16" not in reached


def test_the_integer_matmul_reaches_no_dp4a():
    """The CUDA-core design is gone: no ``__dp4a`` anywhere the C entry
    reaches, nor in the source."""
    text = _text("mpq_matmul.cu")
    reached = _reach(text, "mpq_matmul")
    assert {"launch_int", "int_mma_rows", "int_mma_cols"} <= reached
    assert not any("__dp4a" in (_body(text, f) or "") for f in reached)
    assert "__dp4a" not in (CSRC / "mpq_matmul.cu").read_text()
    assert _body(text, "int_kernel") is None


def test_the_rows_choose_the_integer_route_before_launch():
    body = _body(_text("mpq_matmul.cu"), "launch_int")
    assert re.search(r"if \(small_m\(M\)\)", body)
    assert body.index("int_mma_cols") < body.index("int_mma_rows")
    assert not re.search(r"\btry\b", body)


@pytest.mark.parametrize("source,entry,kernel", [
    ("flash_attention.cu", "launch_fma", "flash_fwd_fma"),
    ("mpq_matmul.cu", "launch_wo_fma", "wo_kernel"),
    ("mla_paged_decode.cu", "launch_fma", "mla_partials_kernel"),
])
def test_float32_routes_stay_on_the_cuda_cores(source, entry, kernel):
    """float32 on tensor cores would be TF32, another function."""
    text = _text(source)
    assert kernel in _reach(text, entry)
    assert not {"mma_bf16", "ldsm_x4", "ldsm_x4_t"} & _reach(text, kernel)


@pytest.mark.parametrize("source,entry,routes", [
    ("flash_attention.cu", "flash_attention_fwd",
     {"launch_mma", "launch_fma"}),
    ("mpq_matmul.cu", "wo_matmul", {"launch_wo_mma", "launch_wo_fma"}),
    ("paged_flash_decode.cu", "paged_flash_decode_partials",
     {"launch_mma", "launch_decode", "launch_fma"}),
    ("paged_flash_decode.cu", "paged_flash_decode_partials_quant",
     {"launch_mma", "launch_decode", "launch_fma"}),
    ("mla_paged_decode.cu", "mla_paged_decode_partials",
     {"launch_mma", "launch_fma"}),
    ("mla_paged_decode.cu", "mla_paged_decode_partials_quant",
     {"launch_mma", "launch_fma"}),
])
def test_the_dtype_chooses_the_route_before_launch(source, entry, routes):
    text = _text(source)
    assert routes <= _reach(text, entry)
    body = _body(text, entry)
    assert "dtype" in body and not re.search(r"\btry\b", body)


def test_paged_kernels_still_include_flash_tile():
    """Both paged sources include the tensor-core header beside the
    shared tile (for the paged GQA kernel's bf16 chunk route and the MLA
    kernel's bf16 route), and the row reader they share."""
    for src in ("paged_flash_decode.cu", "mla_paged_decode.cu"):
        assert {"flash_tile.cuh", "mma.cuh", "page_rows.cuh"} <= \
            _includes(src), src
    for src in ("flash_attention.cu", "mpq_matmul.cu"):
        assert "mma.cuh" in _includes(src), src


@pytest.mark.parametrize("entry", ["paged_flash_decode_partials",
                                   "paged_flash_decode_partials_quant"])
def test_paged_decode_and_float32_routes_keep_flash_tile(entry):
    """Both entries, fp and quantized: the bf16 decode route reaches the
    tensor-core decode kernel (``mma_bf16`` and ``cp_async16``), and
    the float32 decode and chunk routes reach only the CUDA-core kernel,
    which runs on ``FlashTile`` and reaches no tensor-core instruction or
    async copy; the FMA kernel is no longer built for bf16."""
    text = _text("paged_flash_decode.cu")
    assert {"pick_route", "launch_decode", "paged_decode_mma", "launch_fma",
            "paged_partials_kernel"} <= _reach(text, entry)
    assert {"mma_bf16", "cp_async16", "cp_async_wait"} <= \
        _reach(text, "paged_decode_mma")
    assert "FlashTile" in _body(text, "paged_partials_kernel")
    assert not {"mma_bf16", "ldsm_x4", "ldsm_x4_t", "cp_async16"} & \
        _reach(text, "paged_partials_kernel")
    assert "launch_fma<__nv_bfloat16" not in text


def test_the_paged_route_is_chosen_by_dtype_bits_and_rows():
    """bf16 on any pool (fp, int8 or int4 alike: no condition on the
    bits) takes the tensor cores: decode rows (Sq * G <= 16, as
    chip_smoke's ``paged_route``) the one-tile decode kernel, chunks the
    FA2 ring; float32 never reaches an mma route, only FMA blocks of 16
    rows (decode) and 64 (chunks); the choice is made before launch,
    with no ``try``."""
    text = _text("paged_flash_decode.cu")
    body = _body(text, "pick_route")
    assert re.search(r"if constexpr \(std::is_same_v<T, bf16>\) \{\s*"
                     r"if \(rows < MMA_MIN_ROWS\) return launch_decode<BITS, "
                     r"DK, DV>\(a\);\s*return launch_mma<BITS, DK, DV>\(a\);"
                     r"\s*\} else \{\s*"
                     r"if \(rows < MMA_MIN_ROWS\) return launch_fma<T, BITS, "
                     r"DK, DV, 16>\(a\);\s*"
                     r"return launch_fma<T, BITS, DK, DV, 64>\(a\);\s*\}",
                     body)
    assert body.count("launch_mma") == 1 and \
        body.count("launch_decode") == 1 and "BITS ==" not in body and \
        "BITS !=" not in body
    assert re.search(r"constexpr int MMA_MIN_ROWS = 17;", text)
    assert re.search(r"constexpr int DEC_BQ = MMA_MIN_ROWS - 1;", text)
    assert not re.search(r"\btry\b", body)
    # fp pools at every built head pair, quantized ones at 128 / 128
    assert "pick_route<T, 0, DK_, DV_>" in _body(text, "dispatch_dh")
    quant = _body(text, "dispatch_quant")
    for bits in (8, 4):
        assert f"pick_route<T, {bits}, 128, 128>(a)" in quant


@pytest.mark.parametrize("source,macro,wrapper", [
    ("flash_attention.cu", "FLASH_CASE", fa),
    ("paged_flash_decode.cu", "PICK", pfd)])
def test_every_wrapper_head_pair_is_instantiated(source, macro, wrapper):
    """The (dk, dv) pairs a wrapper lets through (``HEAD_DIMS``, zamba2's
    (112, 112) among them) are the pairs its source dispatches on, each
    once, so no launch finds an uninstantiated width; the decode route
    deals its context columns out in 16-column blocks, which 112 (seven
    blocks) divides, instead of the four-warp split that needed dv % 32."""
    text = (CSRC / source).read_text()
    pairs = [tuple(map(int, m)) for m in re.findall(
        rf"^\s*{macro}\((\d+), (\d+)\)\s*$", text, re.M)]
    assert sorted(pairs) == sorted(wrapper.HEAD_DIMS)
    assert (112, 112) in pairs and len(set(pairs)) == len(pairs)
    if source == "paged_flash_decode.cu":
        start = text.index("struct DecodeTile {")
        tile = text[start:_match(text, text.index("{", start), "{", "}")]
        assert "NB = DV / 16" in tile and "% 32" not in tile
        assert "DV % 32" not in _body(text, "paged_decode_mma")
        assert pfd.QUANT_HEAD_DIMS == (128,)


def test_the_quantized_chunk_route_widens_raw_rows_in_shared_memory():
    """On a quantized pool the mma kernel copies the raw rows and their
    scales with ``cp.async`` (a copy cannot dequantize) and widens each
    element as the reference does: the lane, sign-extended by
    ``lane_value``, times the row scale in one float32 multiply
    (``__fmul_rn``, never contracted), rounded to bf16."""
    text = _text("paged_flash_decode.cu")
    reached = _reach(text, "paged_partials_mma")
    assert {"copy_rows", "widen_rows", "widen8", "lane_value", "cp_async4",
            "cp_async16", "pack_bf16", "mma_bf16"} <= reached, reached
    assert "__fmul_rn" in _body(text, "widen8")
    assert "cp.async.ca.shared.global" in _body(text, "cp_async4")
    kernel = _body(text, "paged_partials_mma")
    assert re.search(r"if constexpr \(BITS != 0\) \{[^}]*widen_rows<BITS",
                     kernel)
    # the score, softmax, mask and store code is one piece of source: one
    # kernel template on BITS, no second mma kernel
    assert re.search(r"template <int BITS, int DK, int DV>\s*__global__ "
                     r"void __launch_bounds__\(MMA_NT\)\s*paged_partials_mma",
                     text)
    assert len(re.findall(r"\bmma_bf16\(", kernel)) == 4


def test_the_quantized_decode_route_widens_raw_rows_in_shared_memory():
    """On a quantized pool the decode kernel copies the raw rows and their
    k and v scales with ``cp.async`` into their own region and widens the
    whole tile into the bf16 K and V tiles with the chunk route's
    ``widen_rows`` (the reference's op sequence); the score, softmax,
    mask and store code is one template on BITS for fp, int8 and int4
    pools, whose Q fragments are (q * scale) rounded to bf16."""
    text = _text("paged_flash_decode.cu")
    reached = _reach(text, "paged_decode_mma")
    assert {"copy_rows", "widen_rows", "widen8", "lane_value", "cp_async4",
            "cp_async16", "ldsm_x4", "ldsm_x4_t", "pack_bf16",
            "mma_bf16"} <= reached, reached
    kernel = _body(text, "paged_decode_mma")
    assert re.search(r"copy_rows<RK, RK, BK, MMA_NT>\(Kq, kp, s_row, KV, "
                     r"kvh, tid\);\s*copy_rows<RV, RV, BK, MMA_NT>\(Vq, vp, "
                     r"s_row, KV, kvh, tid\);", kernel)
    assert re.search(r"if constexpr \(BITS != 0\) \{[^}]*"
                     r"widen_rows<BITS, DK, KS, MMA_NT>\(Ks, Kq, Ksc, 0, BK, "
                     r"tid\);\s*widen_rows<BITS, DV, VS, MMA_NT>\(Vs, Vq, "
                     r"Vsc, 0, BK, tid\);", kernel)
    assert re.search(r"template <int BITS, int DK, int DV>\s*__global__ "
                     r"void __launch_bounds__\(MMA_NT\)\s*paged_decode_mma",
                     text)
    assert len(re.findall(r"\bmma_bf16\(", kernel)) == 4
    assert "__syncthreads_or" in kernel
    assert "pack_bf16(f.x * scale, f.y * scale)" in kernel


def test_the_mla_route_is_chosen_by_dtype_alone():
    """float32 takes the FMA kernel and bf16 the tensor-core kernel, on
    any latent pool (one dispatch template on BITS, no condition on the
    bits); the FMA kernel is no longer built for bf16."""
    text = _text("mla_paged_decode.cu")
    body = _body(text, "dispatch_dtype")
    assert re.search(r"if \(dtype == 0\)\s*return launch_fma<float, BITS, "
                     r"512, 64>", body)
    assert re.search(r"if \(dtype == 1\)\s*return launch_mma<BITS, 512, "
                     r"64>", body)
    assert "BITS ==" not in body and not re.search(r"\btry\b", body)
    assert "launch_fma<__nv_bfloat16" not in text
    for entry, bits in (("mla_paged_decode_partials", (0,)),
                        ("mla_paged_decode_partials_quant", (8, 4))):
        for b in bits:
            assert f"dispatch_dtype<{b}>(dtype" in _body(text, entry)


def test_the_mla_route_reads_keys_and_values_from_one_tile():
    """The latent row is key and value at once: the scores' C^T
    (plain ``ldmatrix``) and the context's C (``ldmatrix.trans``) come
    from the same shared tile, which 16-byte ``cp.async`` copies fill
    through the page table; a quantized pool's raw rows and scales
    (4-byte ``cp.async``) are widened into it in two passes (the raw rows
    overlap the tile's tail), with the reference's op sequence."""
    text = _text("mla_paged_decode.cu")
    reached = _reach(text, "mla_partials_mma")
    assert {"copy_rows", "widen_rows", "widen8", "lane_value", "cp_async4",
            "cp_async16", "ldsm_x4", "ldsm_x4_t", "mma_bf16",
            "pack_bf16"} <= reached, reached
    assert "__fmul_rn" in _body(text, "widen8")
    kernel = _body(text, "mla_partials_mma")
    assert re.search(r"const bf16\* Ck = Cs \+", kernel)
    assert re.search(r"const bf16\* Cv = Cs \+", kernel)
    assert re.search(r"ldsm_x4\(kb, Ck \+", kernel)
    assert re.search(r"ldsm_x4_t\(vb, Cv \+", kernel)
    assert re.search(r"widen_rows<BITS, W, CS, MMA_NT>\(Cs, Craw, Ssc, 0, "
                     r"L::SPLIT, tid\);\s*__syncthreads\(\);\s*"
                     r"widen_rows<BITS, W, CS, MMA_NT>\(Cs, Craw, Ssc, "
                     r"L::SPLIT, MMA_BK, tid\);", kernel)
    # one kernel template on BITS for fp, int8 and int4 pools: scores
    # (c_kv and k_rope summed apart) and context in one piece of source
    assert re.search(r"template <int BITS, int R, int DR>\s*__global__ "
                     r"void __launch_bounds__\(MMA_NT\)\s*mla_partials_mma",
                     text)
    assert len(re.findall(r"\bmma_bf16\(", kernel)) == 6
    # the f32 FMA kernel is left as it was: no tensor-core instruction
    assert not {"mma_bf16", "ldsm_x4", "cp_async16"} & \
        _reach(text, "mla_partials_kernel")


def test_the_mla_tile_is_declared_once_beside_the_wrapper():
    """Decode's engine split is one tile of the bf16 routes: the
    wrapper's TILE_KEYS is the MMA_BK of both kernels, and MLA's split
    takes GQA's tile function rather than a tile of its own."""
    for source in ("mla_paged_decode.cu", "paged_flash_decode.cu"):
        tile = re.search(r"constexpr int MMA_BK = (\d+);", _text(source))
        assert tile and int(tile.group(1)) == pfd.TILE_KEYS, source
    model = (PKG / "models" / "mla.py").read_text()
    imported = re.search(r"from repro_torch\.models\.attention import "
                         r"\(([^)]*)\)", model)
    assert imported
    assert "tile_split" in set(re.findall(r"\w+", imported.group(1)))
    assert not re.search(r"^def \w*pages_per_split", model, re.M)
    assert not re.search(r"^[A-Z_]*TILE[A-Z_]* = \d+", model, re.M)
    assert "TILE_KEYS" not in re.sub(r'"""[\s\S]*?"""', "", model)


def test_the_decode_rows_are_the_kernels_route_switch():
    """The engine's decode (one tile a split) is exactly the rows that the
    GQA source sends to its decode route, and ``chip_smoke.py`` names the
    route by the same constant."""
    from repro_torch.models import attention
    rows = re.search(r"constexpr int MMA_MIN_ROWS = (\d+);",
                     _text("paged_flash_decode.cu"))
    assert rows and attention.DECODE_ROWS == int(rows.group(1)) - 1
    smoke = (ROOT / "chip_smoke.py").read_text()
    route = re.search(r"def paged_route\([\s\S]*?\n\n\n", smoke).group(0)
    assert "DECODE_ROWS" in route and not re.search(r"\b16\b", route)


def test_an_edited_header_rebuilds_every_library(tmp_path, monkeypatch):
    """``_build._lib_path`` hashes every ``*.cuh``: editing the new
    tensor-core header gives each source a new library name, so a stale
    build is never loaded."""
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    head = tmp_path / "mma.cuh"
    head.write_text(head.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert all(p.name.startswith(f"lib{n}.") for n, p in after.items())


def test_no_port_file_names_a_library_kernel():
    """No cuBLAS, cuDNN, CUTLASS, fused attention or integer GEMM call
    anywhere in the port: every kernel it launches is its own."""
    pat = re.compile(r"cublas|cudnn|cutlass|scaled_dot_product_attention"
                     r"|_int_mm|_scaled_mm", re.I)
    files = [p for ext in ("*.py", "*.cu", "*.cuh") for p in PKG.rglob(ext)]
    assert len(files) > 20
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("call", ["flash", "wo_matmul", "paged", "mla"])
def test_bf16_wrappers_have_no_fallback_off_the_cpu(call):
    """A bf16 tensor off the CPU reaches the kernel or raises."""
    if call == "mla":
        pool = torch.empty(4, 16, 576, dtype=torch.bfloat16, device="meta")
        qc = torch.empty(1, 1, 16, 512, dtype=torch.bfloat16, device="meta")
        qr = torch.empty(1, 1, 16, 64, dtype=torch.bfloat16, device="meta")
        tbl = torch.zeros(1, 4, dtype=torch.int32, device="meta")
        pos = torch.zeros(1, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            pfd.mla_paged_decode_partials(pool, qc, qr, tbl, pos, 512, 192,
                                          pages_per_split=4)
    elif call == "flash":
        q = torch.empty(1, 4, 2, 32, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            fa.flash_attention(q, q, q)
    elif call == "paged":
        q = torch.empty(1, 17, 2, 32, dtype=torch.bfloat16, device="meta")
        pool = torch.empty(4, 16, 2, 32, dtype=torch.bfloat16, device="meta")
        tbl = torch.zeros(1, 4, dtype=torch.int32, device="meta")
        qpos = torch.zeros(1, 17, dtype=torch.int32, device="meta")
        kvv = torch.zeros(1, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            pfd.paged_flash_decode_partials(pool, pool, q, tbl, qpos, kvv)
    else:
        wp = torch.zeros(32, 16, dtype=torch.int8, device="meta")
        ws = torch.ones(1, 16, device="meta")
        x = torch.empty(3, 64, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            mm.wo_matmul(x, wp, ws, w_bits=4)


def test_the_integer_wrapper_has_no_fallback_off_the_cpu():
    """Integer operands off the CPU reach the kernel or raise."""
    xq = torch.zeros(3, 128, dtype=torch.int8, device="meta")
    xs = torch.ones(3, 1, device="meta")
    wp = torch.zeros(128, 16, dtype=torch.int8, device="meta")
    ws = torch.ones(1, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        mm.mpq_matmul(xq, xs, wp, ws, a_bits=8, w_bits=8)
