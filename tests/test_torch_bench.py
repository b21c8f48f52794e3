"""The port's benches (lif_tpu_torch/bench/) on the CPU at the tiny preset.

The throughput runner's and configs 0, 0b and 0b+'s PSNRs and routed
tiers against lif_tpu's on the same seeded inputs
(tools/reference_bench_psnr.py's reference(), which carries the runners'
inputs into lif_tpu), within 0.05 dB; the headline line's keys; the card
requirement of every runner; a section that raises failing the configs
run; the package's smooth_noise equal to the test suite's; and, by AST,
that the port, chip_smoke.py and the three root runners import neither
jax nor lif_tpu. Configs 1-3 are tests/test_torch_bench_configs.py, the
scaling runner and config 4's oracle tests/test_torch_bench_scaling.py.

The tiny preset's oracle marches 640 steps: at 64, XLA's FMA contraction
flips one grazing pixel of lif_tpu's exact march at the orbit's edge pose
(0.48 off), which moves that pose's PSNR by 0.18 dB.
"""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from lif_tpu_torch.bench import common, configs, scenes, throughput

from . import scenes as test_scenes
from .torch_bench_helpers import (
    ROOT,
    StepLog,
    assert_matches,
    lif_tpu_reference,
    run_sections,
)

CONFIG_SECTIONS = ("config0", "config0b_mesh", "config0b_billboard",
                   "config0b_billboard_kernel")


@pytest.fixture(scope="module")
def lif_tpu_values():
    return lif_tpu_reference(("throughput", "config0", "config0b"))


@pytest.fixture(scope="module")
def config_steps():
    return StepLog()


@pytest.fixture(scope="module")
def config_record(tmp_path_factory, config_steps):
    out = tmp_path_factory.mktemp("bench") / "BENCH_DETAILS_TORCH.json"
    return run_sections(CONFIG_SECTIONS, out, config_steps), out


@pytest.fixture(scope="module")
def throughput_steps():
    return StepLog()


@pytest.fixture(scope="module")
def throughput_lines(throughput_steps):
    return throughput.run(common.TINY, "cpu", 0, observe=throughput_steps)


@pytest.mark.parametrize("section", CONFIG_SECTIONS)
def test_config_section_matches_lif_tpu(config_record, lif_tpu_values,
                                        section):
    record, _ = config_record
    got = record[section]
    assert "error" not in got, got
    assert_matches(got, lif_tpu_values[section])
    assert "cpu_smoke" in got  # every timing of a CPU run, and only there
    assert not {"fps", "batched_fps", "stereo_pairs_per_s"} & set(got)


def test_config_record_is_written(config_record):
    record, out = config_record
    on_disk = json.loads(out.read_text())
    assert set(CONFIG_SECTIONS) <= set(on_disk)
    assert on_disk["misses"] == [] and configs.failures(record) == []
    assert on_disk["_provenance"]["device"] == "cpu"


def test_each_section_observes_its_counted_step(config_record,
                                                config_steps):
    record, _ = config_record
    assert config_steps.steps == [[name, True] for name in CONFIG_SECTIONS]
    for name in CONFIG_SECTIONS:
        # a CPU run launches no kernel: every count stays 0
        assert record[name]["launches"] == {}, name
    assert record["config0"]["tiers"] == ("march",)


def test_throughput_observes_each_counted_step(throughput_lines,
                                               throughput_steps):
    (comp, head), _ = throughput_lines
    assert throughput_steps.steps == [
        [step, True] for step in ("headline", "composite lateral",
                                  "composite orbit", "composite zoom")]
    assert head["launches"] == {}
    assert all(fam["launches"] == {} for fam in comp["families"].values())


def test_record_names_its_sources(config_record):
    record, out = config_record
    prov = json.loads(out.read_text())["_provenance"]
    assert prov["source_sha256"] == common.source_digest(ROOT)
    assert len(prov["source_sha256"]) == 64
    # the default record sits in the build directory git ignores
    for sizes in (common.FULL, common.SMOKE):
        path = configs.default_out(sizes)
        assert path.parent == ROOT / "lif_tpu_torch" / "_build"
        assert path.name.startswith("BENCH_DETAILS_TORCH")


def test_throughput_matches_lif_tpu(throughput_lines, lif_tpu_values):
    (comp, head), misses = throughput_lines
    assert misses == []
    want = lif_tpu_values["throughput"]
    got = dict(head["psnr_dB"], **{f"{name}_tiers": fam["tiers"]
                                   for name, fam in comp["families"].items()})
    assert_matches(got, want)


def test_headline_line_keys(throughput_lines):
    (comp, head), _ = throughput_lines
    json.dumps(comp), json.dumps(head)
    assert {"metric", "value", "unit", "device"} <= set(head)
    assert "vs_baseline" not in head and "vs_baseline" not in comp
    assert head["unit"] == comp["unit"] == "frames/s"
    assert "seeded synthetic 256x160 scene" in head["metric"]
    # a CPU run prints no device metric: its rates sit under cpu_smoke
    assert head["value"] is None and comp["value"] is None
    assert head["device"] == "cpu" and head["cpu_smoke"]["frames_per_s"] > 0
    assert "frames/s" not in head["metric"].split(":", 1)[1]


def test_full_preset_headline_is_nine_chunks():
    from lif_tpu_torch.models import renderer

    assert common.FULL.batch == 432 and common.FULL.third == 144
    assert len(renderer._pose_chunks(common.FULL.batch, 48)) == 9


@pytest.mark.parametrize("main", [throughput.main, configs.main])
def test_runner_without_cpu_flag_needs_a_card(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "tiny", "--out", str(tmp_path / "b.json")]
             if main is configs.main else ["--preset", "tiny"])


def test_root_script_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = subprocess.run([sys.executable, "bench_scaling_torch.py",
                          "--preset", "tiny", "--fused", "none.npz"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert res.stdout == ""


def test_a_failing_section_fails_the_run(monkeypatch, tmp_path):
    def boom(ctx):
        raise RuntimeError("forced")

    monkeypatch.setattr(configs, "SECTIONS", {
        "config0": boom,
        "interactive_planning": configs.SECTIONS["interactive_planning"]})
    out = tmp_path / "b.json"
    rc = configs.main(["--preset", "tiny", "--device", "cpu", "--out",
                       str(out)])
    record = json.loads(out.read_text())
    assert rc != 0
    assert "forced" in record["config0"]["error"]
    assert "error" not in record["interactive_planning"]


@pytest.mark.parametrize("seed,shape,octaves", [
    (0, (800, 1280), 3), (1, (160, 256), 4), (7, (37, 53), 2)])
def test_smooth_noise_equals_the_test_suites(seed, shape, octaves):
    a = scenes.smooth_noise(np.random.default_rng(seed), *shape,
                            octaves=octaves, lo=0.2, hi=0.8)
    b = test_scenes.smooth_noise(np.random.default_rng(seed), *shape,
                                 octaves=octaves, lo=0.2, hi=0.8)
    np.testing.assert_array_equal(a, b)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_port_and_runners_import_no_jax():
    files = sorted((ROOT / "lif_tpu_torch").rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "bench_torch.py",
                                 "bench_configs_torch.py",
                                 "bench_scaling_torch.py")]
    assert len(files) > 40
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "lif_tpu")]
    assert bad == []
