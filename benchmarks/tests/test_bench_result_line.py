import json
import subprocess
import sys

from benchmarks.harness import runner, spec
from benchmarks.tests.conftest import ROOT


def _line(trace):
    cell = spec.load_cell("atms_train_resident")
    out = runner.Outcome(
        rec={"setup_s": 3.0, "samples": 2048, "window_s": 1.0, "steps": 2,
             "step_ms": [1.0, 2.0], "flops_per_step": 1e9, "chips": 1,
             "peak_dtype": "bfloat16", "busy_s": 0.5, "kernels": [],
             "trace_window_s": 1.0},
        checks=[("loss", 1e-3, 1e-2)], attempted=5, failed=0,
        memory_peak_bytes=10,
        trace={"breakdown": {"device_ops": [], "idle_gaps": []},
               "busy_s": 0.5, "trace_window_s": 1.0} if trace else None)
    return runner.result_line(cell, out, trace, {"platform": "gpu"})


def test_last_line_keys():
    for trace in (False, True):
        line = _line(trace)
        keys = list(line)
        want = ["correct", "attempted", "failed", "metrics", "device"]
        assert keys[:5] == want
        assert keys[-1] == "checks"
        assert set(keys) - set(want) <= {"breakdown", "checks"}
        assert ("breakdown" in keys) == trace
        assert json.loads(json.dumps(line)) == line


def test_trace_run_reports_per_layer_metrics_only():
    assert set(_line(False)["metrics"]) == {"train_samples_per_s",
                                            "setup_s"}
    assert set(_line(True)["metrics"]) == {
        "train.step_ms_p50", "train_mfu", "device.idle_share.train"}


def test_streamed_cell_reports_memory_end_to_end_and_its_rate_per_layer():
    cell = spec.load_cell("atms_train_streamed")
    assert {m["name"] for m in cell.end_to_end} == {"train_memory_peak_gb",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "train.samples_per_s.streamed", "loader.wait_ms_per_step",
        "loader.gather_ms_per_batch"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in e2e for m in cell.per_layer)


def test_a_check_over_its_limit_is_not_correct():
    cell = spec.load_cell("atms_train_resident")
    out = runner.Outcome(rec={}, checks=[("loss", 0.2, 0.1)], attempted=1,
                         failed=0, memory_peak_bytes=0)
    assert runner.result_line(cell, out, False, {})["correct"] is False
    out.checks = [("loss", float("nan"), 0.1)]
    assert runner.result_line(cell, out, False, {})["correct"] is False


def test_no_card_no_result(tmp_path):
    r = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "atms_train_resident", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    import shutil

    shutil.copytree(f"{ROOT}/benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmarks.drivers.train_contrastive as t\n"
            "from benchmarks.harness import spec\n"
            "c = spec.load_cell('atms_train_resident', %r)\n"
            "t.run(c, seed=1, seconds=1, trace=False, device='cpu', "
            "t_start=0)" % (str(tmp_path), str(tmp_path)))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "eeg_image_decode_tpu_torch" in r.stderr
