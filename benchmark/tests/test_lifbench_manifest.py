"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./\-]{1,200}")
# a width may never be cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank)$|expansion|experts_per_token|width")


def metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.fullmatch(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


@pytest.mark.parametrize("entry", [*MANIFEST["configs"],
                                   *MANIFEST["workloads"], *metrics()],
                         ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("why", "layer"):
        if key in entry:
            assert LINE.fullmatch(entry[key]), key
    if "file" in entry:  # a configuration's source is a line of text
        assert LINE.fullmatch(entry["source"])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_entries(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["source"].startswith("https://")
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("benchmark/")
    data = json.loads(path.read_text())
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.fullmatch(key) and not WIDTH.search(key)
        assert key in data and key in data.get("published", {})
    assert any(w["config"] == cfg["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files_found(cell):
    """Every file the harness finds a cell's parts by."""
    from benchmark.lifbench import harness, parts

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and NAME.fullmatch(cell["traffic"])
    c = harness.Cell(ROOT, cell["name"])
    for kind, name in (("scenes", c.config["scene"]),
                       ("paths", c.traffic["path"]["kind"]),
                       ("entries", c.traffic["entry"]),
                       ("loops", c.traffic["loop"]),
                       ("reference", c.check["reference"])):
        assert parts.exists(kind, name), (kind, name)
    if "exact" in c.check:
        assert parts.exists("reference", c.check["exact"])
    assert set(c.check["limits"]) == {"max_gap", "mean_gap",
                                      "mismatch_share"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"])), m["name"]


def test_one_reader_serves_a_split_metric():
    """A name split by a last dotted part falls back to the quantity's
    reader; a reader of its own wins."""
    from benchmark.lifbench.harness import Cell

    assert Cell.reader_name("device.idle_share.view") == "device.idle_share"
    assert Cell.reader_name("device.idle_share.batch") == "device.idle_share"
    assert (Cell.reader_name("renderer.launches_per_frame.view")
            == "renderer.launches_per_frame.view")


def test_metric_entries():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], set()).add(m["name"])
        for w in m["workloads"]:
            reports = next(x for x in MANIFEST["end_to_end"]
                           if x["name"] == m["moves"])
            assert w in reports.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_check_budget():
    """A full check's runs fit its time, with the full 24 cells."""
    s = MANIFEST["run_seconds"]
    assert 2 * (s + 60) + 24 * (14 * (s + 60) + 2 * 90) + 1200 <= 43200
