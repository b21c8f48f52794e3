"""The configs runner's sections 1, 1b, 2 and 3 (lif_tpu_torch/bench/
configs.py) on the CPU at the tiny preset: each section's PSNRs and
routed tiers against lif_tpu's on the same seeded inputs
(tools/reference_bench_psnr.py's reference()), within 0.05 dB; config
1b's within PSNR_TOL_REFINE.
"""

import pytest

from lif_tpu_torch.bench import configs

from .torch_bench_helpers import (
    StepLog,
    assert_matches,
    lif_tpu_reference,
    run_sections,
)

# config 1b's target sub-sweep (target_refine=1 on a 2-px ladder) differs
# from lif_tpu's at 10 and 5 of the 40960 pixels of poses 1 and 2 (XLA's
# FMA contraction flips grazing crossings; frames 61.3 and 68.5 dB apart),
# which moves their PSNRs by 0.42 and 0.18 dB
PSNR_TOL_REFINE = 0.5
SECTIONS = ("config1_orbit", "config1b_orbit_step2_refine1",
            "config2_stereo", "config3_ldi")


@pytest.fixture(scope="module")
def lif_tpu_values():
    return lif_tpu_reference(("config1", "config1b", "config2", "config3"))


@pytest.fixture(scope="module")
def steps():
    return StepLog()


@pytest.fixture(scope="module")
def record(tmp_path_factory, steps):
    out = tmp_path_factory.mktemp("bench") / "BENCH_DETAILS_TORCH.json"
    return run_sections(SECTIONS, out, steps)


@pytest.mark.parametrize("section", SECTIONS)
def test_config_section_matches_lif_tpu(record, lif_tpu_values, section):
    got = record[section]
    assert "error" not in got, got
    if section.startswith("config1b"):
        assert_matches(got, lif_tpu_values[section], PSNR_TOL_REFINE)
    else:
        assert_matches(got, lif_tpu_values[section])
    assert "cpu_smoke" in got
    assert not {"batched_fps", "stereo_pairs_per_s",
                "fast_fps_one_call"} & set(got)


def test_each_section_records_its_counted_step(record, steps):
    assert steps.steps == [[name, True] for name in SECTIONS]
    for name in SECTIONS:
        assert record[name]["launches"] == {}, name  # no kernel on the CPU
    assert record["config1b_orbit_step2_refine1"]["tiers"] == ("target",)
    assert record["config3_ldi"]["tiers"] == ("march",) * 3


def test_sections_record_no_miss(record):
    assert configs.failures(record) == []
