"""The port's scaling runner (lif_tpu_torch/bench/scaling.py) on the CPU at
the tiny preset, as the configs runner starts it: config 4's section
writes the fused frames, the scaling section runs the subprocess. The
tile-sharded 256x160 view at 1, 2 and 4 gloo ranks equals 1 rank's
(atol 1e-4) with each rank's share of the march 1/N of the rows; config
4's oracle PSNR at both fuse_tol points within 0.05 dB of lif_tpu's on
the same projectors (tools/reference_bench_psnr.py's reference()).
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

from lif_tpu_torch.bench import common

from .torch_bench_helpers import PSNR_TOL, lif_tpu_reference, run_sections


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's record, lif_tpu's oracle PSNRs): lif_tpu's in a thread
    while the port's scaling subprocess runs."""
    out = tmp_path_factory.mktemp("bench") / "BENCH_DETAILS_TORCH.json"
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(lif_tpu_reference, ("config4",))
        record = run_sections(("config4_fusion", "scaling"), out)
        return record, want.result()["scaling"]


@pytest.fixture(scope="module")
def record(runs):
    return runs[0]


def test_fused_section_writes_the_oracles_inputs(record):
    rec = record["config4_fusion"]
    assert "error" not in rec, rec
    assert rec["projectors"] == 4 and rec["resolution"] == "256x160"
    assert "fused_frames_per_s" in rec["cpu_smoke"]


def test_tile_sharding_parity_and_row_shares(record):
    rec = record["scaling"]
    assert "error" not in rec, rec
    ranks = common.TINY.scaling_ranks
    assert ranks == (1, 2, 4)
    assert rec["tile_parity"] == {str(n): True for n in ranks}
    assert all(rec["tile_max_abs_vs_1_rank"][str(n)] <= 1e-4 for n in ranks)
    assert rec["tile_rows_per_rank"] == {str(n): 160 // n for n in ranks}
    assert rec["tile_work_share_vs_1_rank"] == {str(n): 1 / n for n in ranks}
    assert set(rec["cpu_smoke"]) == {"tile_wall_ms_slowest_rank"}


def test_oracle_psnr_matches_lif_tpu(runs):
    record, want = runs
    got = record["scaling"]
    assert set(want) == {"psnr_default", "psnr_0.1"}
    for key, ref in want.items():
        assert abs(got[key] - ref) <= PSNR_TOL, (key, got[key], ref)
    assert record["misses"] == []
