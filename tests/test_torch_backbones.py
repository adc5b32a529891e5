"""The port's metric backbones (``eval/backbones.py``) against the JAX
package's flax modules, fp32 on the CPU: each of the four whole, on the
port's seeded weights carried across with ``backbone_tree_from_state_dict``
(JAX's tree shaped by ``jax.eval_shape``, its ``apply`` jitted), batch 2 at
64 px (75 px for InceptionV3), max |Δ| ≤ 1e-4 · max |JAX out| (AlexNet's
nodes permuted to (C, H, W) order, torchvision's); the strict round trip of
the two tree converters and their refusals; the parameter counts of the
flax trees; a torchvision-named ``state_dict`` through each ``convert_*``;
``imagenet_preprocess`` and an extractor against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.eval import backbones as jbb
from eeg_image_decode_tpu_torch.eval import backbones as pbb
from eeg_image_decode_tpu_torch.utils import convert as pconvert

#: ``--backbone-params`` key → (the JAX module, the test's input size)
CASES = {"alexnet": (jbb.AlexNetFeatures, 64),
         "inception": (jbb.InceptionV3, 75),
         "effnet": (jbb.EfficientNetB1, 64),
         "swav": (jbb.ResNet50, 64)}

#: the flax trees' sizes, BN statistics included
PARAMS = {"alexnet": 2_469_696, "swav": 23_561_152, "effnet": 6_575_232,
          "inception": 21_820_000}

#: the keys a torchvision ``state_dict`` holds beyond the trunk's
HEADS = {"alexnet": ("classifier.1.weight", "classifier.6.bias"),
         "swav": ("fc.weight", "fc.bias"),
         "inception": ("AuxLogits.fc.weight", "AuxLogits.conv0.conv.weight",
                       "fc.weight"),
         "effnet": ("classifier.1.weight", "classifier.1.bias")}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _port(kind, seed=0):
    return pbb.init_random(pbb.BACKBONES[kind](), seed).eval()


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_backbone_matches_jax(kind):
    module, size = CASES[kind]
    model = _port(kind)
    tree = pconvert.backbone_tree_from_state_dict(kind, model.state_dict())
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(
        np.float32)
    jm = module()
    want_shapes = jax.eval_shape(jm.init, jax.random.key(0),
                                 jnp.asarray(x))["params"]
    assert _shapes(tree) == _shapes(want_shapes)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(tree,
                                                           jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    if kind == "alexnet":  # NHWC nodes → (C, H, W), torchvision's order
        want = {k: np.transpose(np.asarray(v), (0, 3, 1, 2))
                for k, v in want.items()}
    else:
        got, want = {"out": got}, {"out": np.asarray(want)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        scale = np.abs(want[k]).max()
        err = np.abs(got[k].numpy() - want[k]).max()
        assert scale > 0 and err <= 1e-4 * scale, (kind, k, err, scale)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_tree_round_trip_counts_and_refusals(kind):
    sd = _port(kind, seed=2).state_dict()
    tree = pconvert.backbone_tree_from_state_dict(kind, sd)
    assert sum(a.size for a in jax.tree_util.tree_leaves(tree)) == PARAMS[kind]
    assert sum(v.numel() for k, v in sd.items()
               if not k.endswith("num_batches_tracked")) == PARAMS[kind]
    back = pconvert.backbone_state_dict_from_flax(kind, tree)
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    again = pconvert.backbone_tree_from_state_dict(kind, back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, tree)
    pbb.BACKBONES[kind]().load_state_dict(back, strict=True)

    extra = dict(sd, **{"stray.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="stray.weight"):
        pconvert.backbone_tree_from_state_dict(kind, extra)
    dropped = next(k for k in reversed(sd)
                   if not k.endswith("num_batches_tracked"))
    with pytest.raises(KeyError, match=dropped):
        pconvert.backbone_tree_from_state_dict(
            kind, {k: v for k, v in sd.items() if k != dropped})
    first = next(iter(tree))
    with pytest.raises(KeyError, match="missing"):
        pconvert.backbone_state_dict_from_flax(
            kind, {k: v for k, v in tree.items() if k != first})
    with pytest.raises(KeyError, match="stray/kernel"):
        pconvert.backbone_state_dict_from_flax(
            kind, dict(tree, stray={"kernel": np.zeros(1)}))
    with pytest.raises(ValueError, match="kind"):
        pconvert.backbone_tree_from_state_dict("vgg", sd)


@pytest.mark.parametrize("kind,convert", [
    ("alexnet", pbb.convert_alexnet), ("swav", pbb.convert_resnet50),
    ("inception", pbb.convert_inception_v3),
    ("effnet", pbb.convert_efficientnet_b1)])
def test_torchvision_state_dict_loads_strictly(kind, convert):
    """A torchvision-named ``state_dict`` (numpy values, its head keys
    included) → ``convert_*`` → a strict load that reproduces it."""
    sd = _port(kind, seed=3).state_dict()
    rng = np.random.default_rng(0)
    tv = {k: v.numpy() for k, v in sd.items()}
    tv.update({k: rng.normal(size=(4, 3)).astype(np.float32)
               for k in HEADS[kind]})
    model = pbb.BACKBONES[kind]()
    model.load_state_dict(convert(tv), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert all(not k.startswith(HEADS[kind][0].split(".")[0])
               for k in convert(tv))


def test_imagenet_preprocess_and_effnet_extractor_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 300, 300, 3)).astype(np.float32)
    got = pbb.imagenet_preprocess(torch.from_numpy(x), 255)
    want = jbb.imagenet_preprocess(jnp.asarray(x), 255)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    model = _port("effnet", seed=5)
    tree = pconvert.backbone_tree_from_state_dict("effnet",
                                                  model.state_dict())
    got = pbb.make_imagenet_extractor("effnet", model)(torch.from_numpy(x))
    want = np.asarray(jbb.make_imagenet_extractor("effnet", tree)(
        jnp.asarray(x)))
    assert got.shape == (2, 1280)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
