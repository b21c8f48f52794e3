"""What the bench tests share: lif_tpu's values on the runners' inputs
(tools/reference_bench_psnr.py, loaded by path), the comparison, and a
configs run of some of its sections."""

import contextlib
import importlib.util
from pathlib import Path

import pytest

from lif_tpu_torch.bench import common, configs

ROOT = Path(__file__).resolve().parents[1]
PSNR_TOL = 0.05  # dB


def lif_tpu_reference(sections):
    """reference() of tools/reference_bench_psnr.py at the tiny preset:
    {section: {key: dB or tiers}}."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench_psnr", ROOT / "tools" / "reference_bench_psnr.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.reference(common.TINY, 0, sections, log=lambda _: None)


def assert_matches(got, want, tol=PSNR_TOL):
    """Every PSNR of `want` within tol dB in `got`, every route equal."""
    for key, ref in want.items():
        if isinstance(ref, tuple):
            assert common.tiers_tuple(got[key]) == ref, key
        else:
            assert abs(got[key] - ref) <= tol, (key, got[key], ref)


class StepLog:
    """A runner's `observe`: the name of each step it wraps, in order, and
    whether the step's body ran inside."""

    def __init__(self):
        self.steps = []

    @contextlib.contextmanager
    def __call__(self, step):
        self.steps.append([step, False])
        yield
        self.steps[-1][1] = True


def run_sections(names, out, observe=common.unobserved):
    """configs.run at the tiny preset on the CPU over the sections `names`
    only (SECTIONS narrowed for the call)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(configs, "SECTIONS",
                   {name: configs.SECTIONS[name] for name in names})
        return configs.run(common.TINY, "cpu", 0, out, observe=observe)
