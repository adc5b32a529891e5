import subprocess
import sys

from benchmarks.harness import guard
from benchmarks.tests.conftest import ROOT


def test_port_is_not_the_jax_package():
    assert guard.forbidden_modules(
        ["eeg_image_decode_tpu_torch", "eeg_image_decode_tpu_torch.ops",
         "torch", "numpy"]) == []


def test_jax_side_is_found_by_whole_top_level_names():
    found = guard.forbidden_modules(
        ["eeg_image_decode_tpu", "eeg_image_decode_tpu.models.atm_s",
         "jax.numpy", "jaxlib", "flax.linen", "jaxtyping", "flaxen"])
    assert found == ["eeg_image_decode_tpu", "flax", "jax", "jaxlib"]


def test_harness_drivers_and_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmarks.drivers.train_contrastive, "
            "benchmarks.drivers.reconstruct\n"
            "import eeg_image_decode_tpu_torch.train.contrastive, "
            "eeg_image_decode_tpu_torch.server, "
            "eeg_image_decode_tpu_torch.gen.sdxl\n"
            "from benchmarks.harness import guard\n"
            "print(guard.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmarks.reference.atms, benchmarks.reference.sdxl\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('eeg_image_decode')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"
