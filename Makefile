# One-keystroke entry points for builders.  `make test` is the tier-1
# verify command from ROADMAP.md; `make smoke` skips the slow subprocess
# distributed tests for a fast inner loop.

PY ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: test test-torch smoke test-sharded test-quant-pool test-tiered test-spec test-router bench-smoke bench-serve bench serve-demo

test:
	$(PY) -m pytest -x -q

smoke:
	$(PY) -m pytest -x -q -k "not distributed"

# the PyTorch port's parity tests (CPU): the port against the JAX package
# on the same inputs, the packed-weight ones (test_torch_quant.py,
# test_torch_mpq_matmul.py) and the MLA ones (test_torch_mla_kernel.py,
# test_torch_mla_model.py, test_torch_mla_serving.py) included.  Its CUDA
# kernels are checked on a GPU by `python3 chip_smoke.py`.
test-torch:
	$(PY) -m pytest -q tests/test_torch_*.py

# multi-device leg (CI): the sharded-execution and sharded-page-pool
# suites on 8 host devices.  The tests spawn their own subprocesses with
# XLA_FLAGS set, so this also runs on a plain single-device host.
test-sharded:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -m pytest -x -q tests/test_distributed_paging.py \
		tests/test_distributed.py

# quantized page-pool leg (CI): the ServeConfig.kv_format suite —
# fp bit-exactness, int8/int4 error budgets, addressing invariance
# through COW/swap, and the 8-device sharded + Pallas-parity check
# (that test spawns its own subprocess with XLA_FLAGS set, so this
# also runs on a plain single-device host, mirroring test-sharded).
test-quant-pool:
	$(PY) -m pytest -x -q tests/test_quant_pool.py

# tiered page-pool leg (CI): two-tier residency invariants (allocator
# walkers + hypothesis when installed), engine bit-identity through
# eviction/prefetch cycles (GQA+MLA, fp+int4), durable swap-spill,
# oversized contexts, and the 8-device sharded + Pallas legs (that
# test spawns its own subprocess with XLA_FLAGS set, so this also
# runs on a plain single-device host, mirroring test-sharded).
test-tiered:
	$(PY) -m pytest -x -q tests/test_tiered_pool.py

# speculative-decoding leg (CI): truncate_rows rollback invariants,
# greedy bit-identity of the draft/verify path vs plain decode (fp +
# int8 pages, self- and foreign-draft, overcommit/tiered cycles, draft
# pool starvation), twin decode-page sharing, and the 8-device sharded
# + Pallas leg (that test spawns its own subprocess with XLA_FLAGS
# set, so this also runs on a plain single-device host).
test-spec:
	$(PY) -m pytest -x -q tests/test_spec.py

# replica-router leg (CI): the wire format (round-trip exactness +
# strict rejection, hypothesis twins when installed) and the router
# tier — 1-replica bit-identity vs a bare engine, routing policies,
# cross-replica migration bit-identity, and the multi-replica x
# 8-device sharded leg (that test spawns its own subprocess with
# XLA_FLAGS set, so this also runs on a plain single-device host).
test-router:
	$(PY) -m pytest -x -q tests/test_router.py tests/test_wire_properties.py

# tiny end-to-end pass of every serving-benchmark section (CI): asserts
# the benchmark itself still runs, so it cannot silently rot.
bench-smoke:
	$(PY) benchmarks/serve_throughput.py --smoke

bench-serve:
	$(PY) benchmarks/serve_throughput.py

# end-to-end launcher pass on a reduced arch (CI): exercises the session
# serve API (submit/stream/drain, priorities + deadlines) through the
# CLI so the launcher path cannot silently rot.
serve-demo:
	$(PY) -m repro.launch.serve --arch stablelm-3b --reduce \
		--requests 4 --max-batch 2 --max-new-tokens 6

bench:
	$(PY) benchmarks/run.py
