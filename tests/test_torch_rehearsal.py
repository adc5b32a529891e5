"""The full-size rehearsal scripts on the CPU, at the port's tiny sizes.

``scripts/rehearse_fullsize_torch.py`` and ``scripts/rehearse_fullscale_
torch.py`` run at full size on the card (``chip_smoke.py`` phase 18);
here their ``--tiny`` modes run every leg and every step of the same code:
each checkpoint grammar synthesized, converted, loaded strictly and run
(the UNet's and the VAE's bf16 outputs against fp32), and the CLI's cold
run, the uninterrupted epoch, the resume from the sidecar caches, the
export and ``evaluate``.
"""

import importlib.util
import os

from torch_port_case import two_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fullsize_rehearsal_runs_every_leg_tiny():
    fullsize = _script("rehearse_fullsize_torch")
    rows = fullsize.main(["--tiny", "--device", "cpu"])
    assert [r["leg"] for r in rows] == list(fullsize.LEGS)
    assert all(r["ok"] and r["size"] == "tiny" for r in rows)
    by_leg = {r["leg"]: r for r in rows}
    for leg in ("unet", "vae"):
        assert min(by_leg[leg]["row_cosine_fp32"]) >= fullsize.COSINE
    assert by_leg["git"]["ids_shape"] == [2, fullsize.GIT_TOKENS + 1]
    assert by_leg["prior"]["sample_shape"] == [fullsize.PRIOR_ROWS, 64]


def test_fullscale_rehearsal_runs_the_cli_tiny(tmp_path):
    fullscale = _script("rehearse_fullscale_torch")
    report = fullscale.main(["--tiny", "--device", "cpu", "--work-dir",
                             str(tmp_path)])
    assert report["ok"]
    assert report["results_csv_epochs"] == [0, 1, 2, 3]
    assert report["resumed"]["bit_equal"]
    assert report["evaluate"]["equal"]
    assert [r["sidecar"] for r in report["cold"]["reads"]] == [False, False]
    assert [r["sidecar"] for r in report["resumed"]["reads"]] == [True, True]
    # each sidecar read whole through the native map, as numpy reads it
    assert [(r["native"], r["sums_equal"]) for r in report["sidecar_reads"]
            ] == [(True, True), (True, True)]
    assert report["training_steps"] == 5 * 10  # 80 rows at B 8, 5 epochs
    assert os.listdir(tmp_path) == []  # the tree is gone
