"""The port's real-artifact acceptance runbook must itself keep working.

``scripts/acceptance_torch.py --dry-run --device cpu`` writes the tiny
synthetic stand-in tree of ``scripts/acceptance_real.py`` in the on-disk
formats the real artifacts use and drives the full chain — retrieval
training → feature export → prior training → generation → metric table —
through the port's CLI. It runs in a child process that imports no JAX (the
card host has none), with two intra-op threads; the report is held to what
``tests/test_acceptance_runbook.py`` holds the JAX runbook's to.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: modules the runbook, ``chip_smoke.py`` and the port must never load
NO_JAX = "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'eeg_image_decode_tpu')"


def _child(code: str, *args: str, timeout: int) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_acceptance_dry_run_full_chain(tmp_path):
    pytest.importorskip("PIL")
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "sys.path.insert(0, 'scripts')\n"
        "import acceptance_torch\n"
        "rc = acceptance_torch.main(['--dry-run', '--device', 'cpu', "
        "'--work-dir', sys.argv[1]])\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {NO_JAX}]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    proc = _child(code, str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "OVERALL: PASS" in proc.stdout

    with open(tmp_path / "acceptance_report.json") as f:
        report = json.load(f)
    assert report["ok"]
    stages = {r["stage"]: r for r in report["stages"]}
    assert set(stages) == {"retrieval", "prior", "generate", "metrics"}
    assert stages["retrieval"]["status"] in ("pass", "warn")
    assert stages["generate"]["images"] == stages["generate"]["expected"]
    assert stages["metrics"]["status"] == "pass"
    assert "pixcorr" in {k.lower() for k in stages["metrics"]["table"]}
    # each stage records its seconds (chip_smoke.py phase 16 reads them)
    assert all(r["seconds"] > 0 for r in stages.values()), stages

    # the artifacts a real acceptance run hands to the next stage exist
    assert (tmp_path / "eeg_features.npz").exists()
    assert (tmp_path / "prior" / "diffusion_prior.pkl").exists()


def test_runbook_and_chip_smoke_import_without_jax():
    """The card host has no JAX: the runbook, the full-size rehearsals
    (the checkpoint grammars and both rehearsal scripts), the walkthrough
    ``examples/end_to_end_torch.py`` and ``chip_smoke.py`` import none of
    it, nor the JAX package; ``chip_smoke.py`` imports the runbook's, the
    rehearsals', the two trajectory scripts' and the walkthrough's modules
    from its own checkout, and the trajectory scripts' port-side halves,
    which phase 19 runs, train and sample without loading it."""
    code = (
        "import importlib.util, sys\n"
        "def load(name, path):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "load('acceptance_torch', 'scripts/acceptance_torch.py')\n"
        "for name in ('checkpoint_grammar_torch', 'rehearse_fullsize_torch',"
        " 'rehearse_fullscale_torch'):\n"
        "    load(name, f'scripts/{name}.py')\n"
        "smoke = load('chip_smoke', 'chip_smoke.py')\n"
        "smoke.load_runbook()\n"
        "for name in ('rehearse_fullsize_torch', 'rehearse_fullscale_torch'):\n"
        "    smoke.load_script(name)\n"
        "smoke.load_example()\n"
        "ppt = smoke.load_script('parity_torch_prior_trajectory')\n"
        "cfg = ppt.prior_config(ppt.NARROW, 4)\n"
        "c, h = ppt.make_data(16, 64, 48, 0)\n"
        "d = ppt.draw_shared(16, 8, 2, 64, 1000, 0.1, 0)\n"
        "r = ppt.run_port_injected(ppt.port_init(cfg, 0), cfg, c, h, d)\n"
        "ppt.port_samples(r['pipe'], c[:2], ppt.sample_noise(2, 64, 3, 0),"
        " steps=3)\n"
        "plt = smoke.load_script('parity_torch_lowlevel_trajectory')\n"
        "eeg, lat = plt.make_data(8, 0)\n"
        "sd = plt.port_model((8,) * 6, 4).reset_parameters(0).state_dict()\n"
        "_, _, t = plt.run_port(sd, eeg, lat, epochs=1, batch=4, lr=1e-3,"
        " seed=0, stages=(8,) * 6, time_proj=4)\n"
        "plt.predict_port(t, eeg[:2])\n"
        "import eeg_image_decode_tpu_torch.cli\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {NO_JAX}]\n"
        "assert not bad, bad\n"
    )
    proc = _child(code, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_runbook_needs_its_inputs_outside_a_dry_run(tmp_path, capsys):
    """Without --data-path and --features, and outside --dry-run, the
    runbook stops before it runs anything, as the JAX runbook does."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import acceptance_torch
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    with pytest.raises(SystemExit) as e:
        acceptance_torch.main(["--work-dir", str(tmp_path)])
    assert e.value.code == 2
    assert "--data-path and --features are required" in (
        capsys.readouterr().err)
