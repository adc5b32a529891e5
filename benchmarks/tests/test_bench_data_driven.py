"""A configuration, a traffic mix and a metric added as new files, with
entries in BENCHMARK.json, are found by name; no existing file changes."""

import hashlib
import json
import shutil
from pathlib import Path

from benchmarks.harness import runner, spec
from benchmarks.tests.conftest import ROOT


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted((root / "benchmarks").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(Path(ROOT) / "benchmarks", root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Path(ROOT) / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)

    cfg = json.loads((root / "benchmarks/configs/atms_s_things_eeg.json"
                      ).read_text())
    cfg["train"]["batch_size"] = 512
    (root / "benchmarks/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (root / "benchmarks/mixes/dummy_mix.json").write_text(json.dumps(
        {"kind": "train_epochs", "feed": "resident", "host_dtype": None,
         "trace_epoch": 5}))
    (root / "benchmarks/metrics/dummy.steps_seen.py").write_text(
        'UNIT = "steps"\nLAYER = "trainer"\nMOVES = "train_samples_per_s"\n'
        'SOURCE = "program_counter"\n\n\ndef read(rec):\n'
        '    return rec.get("steps")\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "x",
                             "file": "benchmarks/configs/dummy_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0].setdefault("workloads", []).append("dummy_cell")
    bench["per_layer"].append({"name": "dummy.steps_seen", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "trainer",
                               "moves": "train_samples_per_s",
                               "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("dummy_cell", root)
    assert cell.config["train"]["batch_size"] == 512
    assert cell.mix["trace_epoch"] == 5
    assert spec.driver(cell).__name__.endswith("train_contrastive")
    names = [m["name"] for m in cell.per_layer]
    assert "dummy.steps_seen" in names
    metrics = runner.read_metrics(cell, cell.per_layer, {"steps": 12})
    assert metrics["dummy.steps_seen"] == {"value": 12.0, "unit": "steps"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_entry_has_its_files():
    bench = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        for m in cell.end_to_end + cell.per_layer:
            mod = spec.reader(cell, m)
            assert mod.SOURCE == m["source"]
            if "layer" in m:
                assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
