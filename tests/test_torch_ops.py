"""The port's three kernel modules against the JAX kernels.

On this host the JAX kernels run in Pallas interpret mode and the port's
wrappers run their plain PyTorch versions (the tensors lie on the CPU); both
see the same numpy inputs and weights. Tolerance: fp32 throughout, JAX at
'highest' matmul precision (conftest.py), atol = rtol = 1e-4 per op — the
two sides differ only in fp32 summation order.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eeg_image_decode_tpu.ops import attention as jax_attention
from eeg_image_decode_tpu.ops import projection as jax_projection
from eeg_image_decode_tpu.ops import tsconv as jax_tsconv
from eeg_image_decode_tpu_torch.ops import _build
from eeg_image_decode_tpu_torch.ops.attention import (
    attention_layer_reference,
    fused_attention_layer,
)
from eeg_image_decode_tpu_torch.ops.projection import (
    fused_projection_head,
    projection_head_reference,
)
from eeg_image_decode_tpu_torch.ops.tsconv import (
    fold_pool_into_kernel,
    tsconv_pool_fused,
    tsconv_pool_reference,
)
from torch_port_case import attention_params, projection_params

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = Path(__file__).resolve().parent.parent


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# (d_model, heads, d_ff): the second truncates the heads like ATM-S's
# 250 → 4 × 62 = 248
@pytest.mark.parametrize("d,heads,ff", [(32, 4, 64), (30, 4, 40)])
def test_attention_matches_jax_kernel(d, heads, ff):
    rng = np.random.default_rng(1)
    inner = (d // heads) * heads
    x = rng.normal(size=(3, 9, d)).astype(np.float32)
    params = attention_params(rng, d, inner, ff)
    want = np.asarray(jax_attention.fused_attention_layer(
        jnp.asarray(x), _j(params), None, heads, True))
    with torch.no_grad():
        got = fused_attention_layer(torch.from_numpy(x), _t(params), heads)
        plain = attention_layer_reference(torch.from_numpy(x), _t(params),
                                          heads)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_tsconv_matches_jax_kernel():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 100)).astype(np.float32)
    w = (rng.normal(size=(9, 6)) / 3.0).astype(np.float32)
    w_tilde_jax = jax_tsconv.fold_pool_into_kernel(jnp.asarray(w), 16)
    w_tilde = fold_pool_into_kernel(torch.from_numpy(w), 16)
    np.testing.assert_allclose(w_tilde.numpy(), np.asarray(w_tilde_jax),
                               **TOL)
    want = np.asarray(jax_tsconv.tsconv_pool_fused(
        jnp.asarray(x), w_tilde_jax, 4, True))
    got = tsconv_pool_fused(torch.from_numpy(x), w_tilde, 4)
    plain = tsconv_pool_reference(torch.from_numpy(x), w_tilde, 4)
    assert got.shape == want.shape == (2, 8, 20, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_projection_matches_jax_kernel():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 48)).astype(np.float32)
    params = projection_params(rng, 48, 32)
    want = np.asarray(jax_projection.fused_projection_head(
        jnp.asarray(x), _j(params), None, 0.0, True))
    got = fused_projection_head(torch.from_numpy(x), _t(params))
    plain = projection_head_reference(torch.from_numpy(x), _t(params))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_cpu_wrappers_launch_no_kernel():
    """A CPU tensor runs the plain version: no launch is counted."""
    _build.reset_launches()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 48)).astype(np.float32))
    fused_projection_head(x, _t(projection_params(rng, 48, 32)))
    assert _build.LAUNCHES == {k: 0 for k in _build.LAUNCHES}


def test_package_imports_without_jax(tmp_path):
    """The port imports no JAX, flax, optax, orbax or JAX-package module,
    also when ``cli features --tiny`` runs (its pickle reader, towers,
    tokenizer, image reader and cache writer), a plot is drawn, and the
    diffusion prior and the low-level encoder train, sample and round-trip
    their files, a reconstruction runs through the generator, and a row is
    captioned through the GIT decoder (no transformers either), ``cli
    metrics`` scores a tiny tree through a seeded AlexNet (no torchvision
    either), and every encoder of the registry is built (no braindecode
    either)."""
    code = (
        "import sys\n"
        "import eeg_image_decode_tpu_torch.cli\n"
        "import eeg_image_decode_tpu_torch.core.checkpoint\n"
        "import eeg_image_decode_tpu_torch.data.features\n"
        "import eeg_image_decode_tpu_torch.data.things_eeg\n"
        "import eeg_image_decode_tpu_torch.data.tokenizers\n"
        "import eeg_image_decode_tpu_torch.models.clip_vit\n"
        "import eeg_image_decode_tpu_torch.ops.philox\n"
        "import eeg_image_decode_tpu_torch.data.synthetic\n"
        "import eeg_image_decode_tpu_torch.losses\n"
        "import eeg_image_decode_tpu_torch.models.diffusion_prior\n"
        "import eeg_image_decode_tpu_torch.models.lowlevel\n"
        "import eeg_image_decode_tpu_torch.ops.ddpm\n"
        "import eeg_image_decode_tpu_torch.train.lowlevel\n"
        "import eeg_image_decode_tpu_torch.train.optim\n"
        "import eeg_image_decode_tpu_torch.train.prior\n"
        "import eeg_image_decode_tpu_torch.train.contrastive\n"
        "import eeg_image_decode_tpu_torch.train.evaluator\n"
        "import eeg_image_decode_tpu_torch.utils.convert\n"
        "import eeg_image_decode_tpu_torch.utils.convert_clip\n"
        "import eeg_image_decode_tpu_torch.utils.plotting\n"
        "import pickle, numpy as np\n"
        "from eeg_image_decode_tpu_torch import cli\n"
        "from PIL import Image\n"
        "from eeg_image_decode_tpu_torch.data.synthetic import "
        "write_synthetic_clip_vocab\n"
        "from eeg_image_decode_tpu_torch.models import clip_vit as c\n"
        "from eeg_image_decode_tpu_torch.utils.convert_clip import "
        "clip_tree_from_state_dict as tree\n"
        "from eeg_image_decode_tpu_torch.utils.plotting import "
        "plot_training_summary\n"
        "d = sys.argv[1]\n"
        "import os; os.makedirs(d + '/img/00001_cat')\n"
        "Image.new('RGB', (40, 32)).save(d + '/img/00001_cat/a.png')\n"
        "v, m = write_synthetic_clip_vocab(d, ['This picture is cat'], "
        "vocab_size=600)\n"
        "vc = c.CLIPVisionConfig.tiny()\n"
        "tc = c.CLIPTextConfig(vocab_size=600, context_length=16, width=32, "
        "layers=2, heads=2, embed_dim=32)\n"
        "pickle.dump({'vision': tree(c.CLIPVisionTower(vc, seed=0)"
        ".state_dict(), 'vision', 2), 'text': tree(c.CLIPTextTower(tc, "
        "seed=1).state_dict(), 'text', 2)}, open(d + '/p.pkl', 'wb'))\n"
        "cli.main(['features', '--images-dir', d + '/img', '--clip-params', "
        "d + '/p.pkl', '--vocab', v, '--merges', m, '--cache-dir', d, "
        "'--tiny', '--device', 'cpu'])\n"
        "plot_training_summary([{'epoch': 0, 'loss': 1.0}], d + '/s.png')\n"
        "from eeg_image_decode_tpu_torch.core.config import PriorConfig, "
        "LowLevelConfig\n"
        "from eeg_image_decode_tpu_torch.train.prior import PriorPipe\n"
        "from eeg_image_decode_tpu_torch.train.lowlevel import "
        "LowLevelTrainer\n"
        "from eeg_image_decode_tpu_torch.models.lowlevel import "
        "EncoderLowLevel\n"
        "r = np.random.default_rng(0)\n"
        "p = PriorPipe(PriorConfig.tiny(), device='cpu')\n"
        "p.train(r.normal(size=(16, 64)), r.normal(size=(16, 64)), epochs=1, "
        "log_fn=None)\n"
        "p.generate(r.normal(size=(2, 64)))\n"
        "PriorPipe.from_checkpoint(p.save_with_config(d + '/prior.pkl'), "
        "device='cpu')\n"
        "t = LowLevelTrainer(LowLevelConfig(time_proj_dim=2), device='cpu', "
        "model=EncoderLowLevel(time_proj_dim=2, stage_channels=(4,) * 6))\n"
        "t.train(r.normal(size=(4, 63, 250)), r.normal(size=(4, 4, 64, 64)), "
        "epochs=1, batch_size=2, log_fn=None)\n"
        "import torch\n"
        "from eeg_image_decode_tpu_torch.gen.sdxl import "
        "Generator4Embeds, GeneratorConfig\n"
        "import eeg_image_decode_tpu_torch.gen.convert\n"
        "import eeg_image_decode_tpu_torch.gen.text_encoder\n"
        "import eeg_image_decode_tpu_torch.ops.euler\n"
        "import eeg_image_decode_tpu_torch.server\n"
        "from eeg_image_decode_tpu_torch.serve import ReconstructionService\n"
        "from eeg_image_decode_tpu_torch.models.registry import "
        "build_encoder\n"
        "from eeg_image_decode_tpu_torch.core.config import ATMSConfig\n"
        "g = Generator4Embeds(GeneratorConfig.tiny(), dtype=torch.float32, "
        "device='cpu')\n"
        "g.init_random(0)\n"
        "pp = PriorPipe(PriorConfig(embed_dim=64, cond_dim=1024, "
        "hidden_dims=(64, 32), time_embed_dim=32, num_inference_steps=2), "
        "device='cpu')\n"
        "pp.init(1)\n"
        "svc = ReconstructionService(build_encoder('atms', "
        "config=ATMSConfig(), device='cpu'), pp, g, max_batch=1, "
        "device='cpu')\n"
        "assert svc.reconstruct(r.normal(size=(1, 63, 250)), 0).shape == "
        "(1, 16, 16, 3)\n"
        "from eeg_image_decode_tpu_torch.models.git_caption import "
        "GITCaptioner, GITConfig, PixelProjector\n"
        "from eeg_image_decode_tpu_torch.serve import CaptionService\n"
        "from eeg_image_decode_tpu_torch.data.tokenizers import "
        "WordPieceTokenizer\n"
        "from eeg_image_decode_tpu_torch.data.synthetic import "
        "write_synthetic_wordpiece_vocab\n"
        "import eeg_image_decode_tpu_torch.train.adapters\n"
        "gc = GITConfig.tiny()\n"
        "tok = WordPieceTokenizer.from_file(write_synthetic_wordpiece_vocab("
        "d, vocab_size=64, cls_id=1, sep_id=2))\n"
        "cs = CaptionService(svc.model, pp, GITCaptioner(gc).init_random(0), "
        "PixelProjector(3, 64, 16).init_random(1), tok, max_batch=1, "
        "device='cpu')\n"
        "assert len(cs.caption(r.normal(size=(1, 63, 250)), 0)) == 1\n"
        "import eeg_image_decode_tpu_torch.eval.recon_metrics\n"
        "import eeg_image_decode_tpu_torch.eval.backbones as bb\n"
        "from eeg_image_decode_tpu_torch.utils.convert import "
        "backbone_tree_from_state_dict\n"
        "os.makedirs(d + '/gt')\n"
        "for i in range(3):\n"
        "    os.makedirs(d + f'/gen/class_{i:04d}')\n"
        "    Image.new('RGB', (24, 24), (40 * i, 9, 0)).save("
        "d + f'/gen/class_{i:04d}/0.png')\n"
        "    Image.new('RGB', (30, 30), (9, 40 * i, 0)).save("
        "d + f'/gt/{i}.png')\n"
        "pickle.dump({'alexnet': backbone_tree_from_state_dict('alexnet', "
        "bb.init_random(bb.AlexNetFeatures(), 0).state_dict())}, "
        "open(d + '/bb.pkl', 'wb'))\n"
        "cli.main(['metrics', '--generated', d + '/gen', '--ground-truth', "
        "d + '/gt', '--image-size', '16', '--backbone-params', "
        "d + '/bb.pkl', '--device', 'cpu'])\n"
        "import eeg_image_decode_tpu_torch.models.nice\n"
        "import eeg_image_decode_tpu_torch.models.eegnetv4\n"
        "import eeg_image_decode_tpu_torch.models.atm_e\n"
        "import eeg_image_decode_tpu_torch.models.baselines\n"
        "from eeg_image_decode_tpu_torch.models.registry import ENCODERS\n"
        "for name in ENCODERS:\n"
        "    build_encoder(name, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transformers', "
        "'torchvision', 'braindecode', 'eeg_image_decode_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                   check=True, timeout=120)
