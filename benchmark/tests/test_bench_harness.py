"""The harness finds what BENCHMARK.json names by file name; its bounds,
records and module check; the FLOP count the MFU reads."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import bounds, harness, synthetic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_bench_spec_finds_cell_files(workload):
    spec = harness.Spec(workload, ROOT)
    assert spec.config_entry["file"].startswith("benchmark/configs/")
    assert spec.cell["limits"]
    importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")
    assert spec.end_to_end() and spec.per_layer()
    for m in spec.end_to_end() + spec.per_layer():
        module = importlib.import_module("benchmark.metrics." + m["name"].replace(".", "_"))
        assert callable(module.read)


def test_bench_every_metric_has_a_reader_and_pattern_files_exist():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "benchmark/metrics" / (m["name"].replace(".", "_") + ".py")).exists()
    from benchmark.lib.readers import FUNCTIONS, patterns
    for f in FUNCTIONS:
        assert patterns(f)


def test_bench_spec_refuses_unknown_workload():
    with pytest.raises(SystemExit):
        harness.Spec("no-such-cell", ROOT)


def test_bench_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["k3m_tpu_torch", "k3m_tpu_torch.model.layers",
                                      "benchmark.run", "torch"]) == []
    assert harness.forbidden_modules(["k3m_tpu.model", "k3m_tpu_torch"]) == ["k3m_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "flax", "optax", "chip_smoke", "bench",
                                      "__graft_entry__", "jaxlib.xla"]) == sorted(
        ["jax", "flax", "optax", "chip_smoke", "bench", "__graft_entry__", "jaxlib"])


def test_bench_harness_and_reference_import_no_forbidden_module():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.run, benchmark.drivers.pretrain, benchmark.drivers.score,"
            " benchmark.reference.check_pretrain, benchmark.reference.check_score,"
            " benchmark.readings, benchmark.lib.kernel_calls;"
            "from benchmark.lib.harness import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_bench_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark/reference").rglob("*.py"):
        text = path.read_text()
        assert "import k3m_tpu" not in text and "from k3m_tpu" not in text, path
        assert "import jax" not in text and "from jax" not in text, path


def test_bench_records_are_the_same_for_the_same_seed(tmp_path):
    a, b = synthetic.item_record(2 ** 31 + 5, 3), synthetic.item_record(2 ** 31 + 5, 3)
    c = synthetic.item_record(2 ** 31 + 6, 3)
    assert a["title"] == b["title"] and a["pv"] == b["pv"]
    assert np.array_equal(a["features"], b["features"])
    assert not np.array_equal(a["features"], c["features"])
    synthetic.write_pretrain_records(str(tmp_path / "a.k3mr"), 2 ** 31 + 5, 3)
    synthetic.write_pretrain_records(str(tmp_path / "b.k3mr"), 2 ** 31 + 5, 3)
    assert (tmp_path / "a.k3mr").read_bytes() == (tmp_path / "b.k3mr").read_bytes()
    synthetic.write_pair_records(str(tmp_path / "p.k3mr"), 2 ** 31 + 5, 2)
    synthetic.write_pair_records(str(tmp_path / "q.k3mr"), 2 ** 31 + 5, 2)
    assert (tmp_path / "p.k3mr").read_bytes() == (tmp_path / "q.k3mr").read_bytes()


def test_bench_reference_inputs_match_the_program_preprocessing():
    from k3m_tpu_torch.data.preprocess import PairPreprocessor, ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer
    from benchmark.reference.inputs import item_inputs
    seed = 2 ** 31 + 99
    got = PairPreprocessor(get_tokenizer(None, 21128), ShapeSpec())._one(
        synthetic.item_record(seed, 4))
    want = item_inputs(synthetic.item_draws(seed, 4), 50, 256, 30)
    for k in ("input_ids", "input_mask", "input_ids_pv", "input_mask_pv", "index_p", "index_v"):
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["image_loc"], want["image_loc"][1:])
    assert np.array_equal(got["image_feat"], want["image_feat"][1:])


def _ms(b):
    return 1e3 * b


def test_bench_kernel_bounds_at_the_main_path_shapes():
    bf = torch.bfloat16
    x = torch.empty((24576, 768), dtype=bf, device="meta")
    s = torch.empty(768, device="meta")
    # #1: LN forward on the B96 pv rows with a residual (PERF.md: 0.0338 ms, bytes)
    assert _ms(bounds.layernorm_fwd(x, s, s, x, bf)) == pytest.approx(0.0338, abs=5e-5)
    rstd = torch.empty(24576, device="meta")
    assert _ms(bounds.layernorm_bwd(x, rstd, s, s, x, bf)) == pytest.approx(0.0338, abs=1e-4)
    q = torch.empty((96, 256, 12, 64), dtype=bf, device="meta")
    bias = torch.empty((96, 256), device="meta")
    # #3: L256 D64 at B96 (0.0451 ms, bytes)
    assert _ms(bounds.attention_fwd(q, q, q, bias)) == pytest.approx(0.0451, abs=1e-4)
    # #4: with the forward's O, lse and mask words (0.0933 ms)
    lse = torch.empty((96, 12, 256), device="meta")
    words = torch.empty((96, 12, 256, 8), dtype=torch.int32, device="meta")
    assert _ms(bounds.attention_bwd(q, q, q, bias, q, lse, words, q)) == pytest.approx(
        0.0933, abs=2e-4)
    # #5: 37 <-> 256 at D128, 8 heads (0.0688 ms)
    q1 = torch.empty((96, 37, 8, 128), dtype=bf, device="meta")
    q2 = torch.empty((96, 256, 8, 128), dtype=bf, device="meta")
    b1, b2 = torch.empty((96, 37), device="meta"), torch.empty((96, 256), device="meta")
    assert _ms(bounds.biattention_fwd(q1, q1, q1, b1, q2, q2, q2, b2)) == pytest.approx(
        0.0688, abs=1e-4)


def test_bench_percentile():
    assert harness.percentile([1, 2, 3, 4, 5], 90) == pytest.approx(4.6)
    assert harness.percentile([7.0], 90) == 7.0


def test_bench_readers_on_a_made_up_run():
    from benchmark.lib import readers
    run = harness.Run(harness.Spec("pretrain-packed-b96", ROOT), 1, 30.0, True)
    run.window = dict(work=960, seconds=10.0, attempted=10, failed=0, steps=10)
    run.flops_per_item = 574e9
    run.profile = dict(n_steps=2, window_s=5.0, busy_s=1.0,
                       kernels=[("void attn_bwd_dq_mma_kernel<64>(k3m::BwdArgs)", 0.004),
                                ("nvjet_tst_192x192", 0.5)])
    run.kernel_calls = [("attention_bwd", 0.001), ("fused_layernorm", 0.0)]
    # 96 samples/s of 574 GFLOP over one card's 989 TFLOP/s
    assert readers.mfu(run, "pretrain") == pytest.approx(100 * 574e9 * 96 / 989e12)
    # a traced step busy 0.5 s of the window's 1 s steps
    assert readers.idle_share(run, "pretrain") == pytest.approx(50.0)
    assert readers.roofline(run, ("attention_bwd",), "pretrain") == pytest.approx(25.0)
    assert readers.launches(run, "pretrain") == 1.0
    assert readers.rate(run, "score") is None
    run.kernel_calls = None
    assert readers.roofline(run, ("attention_bwd",), "pretrain") is None
