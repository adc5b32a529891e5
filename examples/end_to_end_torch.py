"""End-to-end walkthrough of the PyTorch port, stage for stage as
``examples/end_to_end.py`` walks the JAX package: retrieval training →
feature export → diffusion prior → image generation → reconstruction
metrics → captions.

Runs on synthetic data, so it needs no THINGS-EEG download; on real data
swap ``make_synthetic_retrieval_data`` for ``data/things_eeg.py::
build_retrieval_data`` and a CLIP feature cache. It runs on the CUDA card
by default, where NICE's ``TSConv`` launches the tsconv forward and
backward kernels; ``--device cpu`` runs the plain versions on the CPU:

    python3 examples/end_to_end_torch.py [--device cpu]

Files go under a temporary directory that is removed at the end. The last
line printed is one JSON object with every stage's result.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from eeg_image_decode_tpu_torch.core.config import (  # noqa: E402
    ContrastiveTrainConfig,
    PriorConfig,
)
from eeg_image_decode_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_retrieval_data,
)
from eeg_image_decode_tpu_torch.data.tokenizers import (  # noqa: E402
    WordPieceTokenizer,
)
from eeg_image_decode_tpu_torch.eval.recon_metrics import (  # noqa: E402
    reconstruction_metrics,
)
from eeg_image_decode_tpu_torch.gen.sdxl import (  # noqa: E402
    Generator4Embeds,
    GeneratorConfig,
)
from eeg_image_decode_tpu_torch.models.git_caption import (  # noqa: E402
    GITCaptioner,
    GITConfig,
    PixelProjector,
    caption_embeddings,
)
from eeg_image_decode_tpu_torch.models.registry import (  # noqa: E402
    build_encoder,
)
from eeg_image_decode_tpu_torch.train.contrastive import (  # noqa: E402
    ContrastiveTrainer,
)
from eeg_image_decode_tpu_torch.train.evaluator import (  # noqa: E402
    retrieval_eval,
)
from eeg_image_decode_tpu_torch.train.prior import PriorPipe  # noqa: E402
from eeg_image_decode_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def seeded(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # — 1. data (synthetic THINGS-EEG-shaped) —
    train, test = make_synthetic_retrieval_data(
        n_classes=16, images_per_class=4, train_reps=2, clip_dim=64, snr=2.0,
        device=device)

    # — 2. contrastive encoder, reconstruction objective (the generation
    #      pipeline's encoder; recon_loss=False for pure retrieval) —
    cfg = ContrastiveTrainConfig(batch_size=32, epochs=4, lr=1e-3,
                                 recon_loss=True, eval_ks=(2, 16))
    trainer = ContrastiveTrainer(
        build_encoder("nice", proj_dim=64, device=device), cfg, train, test,
        device=device)
    trainer.fit(log_fn=None)
    retrieval = trainer.evaluate()
    print("retrieval eval:", retrieval)

    with tempfile.TemporaryDirectory(prefix="end_to_end_torch_") as tmp:
        # — 3. EEG features (the prior's training pairs) —
        d = np.load(trainer.export_features(os.path.join(
            tmp, "eeg_features.npz")))

        # — 4. diffusion prior: EEG features → CLIP image-embedding space —
        h = d["img_features"]
        hmax = float(np.abs(h).max())
        pipe = PriorPipe(PriorConfig(
            embed_dim=64, cond_dim=64, hidden_dims=(256, 128, 64),
            time_embed_dim=64, epochs=200, batch_size=64, lr=1e-3,
            warmup_steps=100, num_inference_steps=50, guidance_scale=5.0,
        ), device=device)
        pipe.train(d["eeg_features"], h / hmax, log_fn=None)
        prior_path = pipe.save(os.path.join(tmp, "diffusion_prior.pkl"))
        print("prior saved:", os.path.basename(prior_path),
              os.path.getsize(prior_path), "bytes")
        gen_emb = pipe.generate(d["eeg_features_test"], generator=seeded(0))
        out = retrieval_eval(
            gen_emb, test.img_features / hmax,
            torch.as_tensor(d["labels_test"], device=device), ks=(2, 16),
            generator=seeded(1))
        generated_retrieval = {k: float(v) for k, v in out.items()}
        print("generated-embedding retrieval:",
              {k: round(v, 3) for k, v in generated_retrieval.items()})

    # — 5. images via the SDXL-style generator (tiny config; GeneratorConfig()
    #      and gen/convert.py with real SDXL-turbo weights) —
    gen = Generator4Embeds(GeneratorConfig.tiny(), dtype=torch.float32,
                           device=device)
    gen.init_random(0)
    # the 64-d demo embeddings padded to the generator's width
    emb = torch.zeros((4, gen.config.unet.ip_image_embed_dim), device=device)
    emb[:, :64] = gen_emb[:4]
    imgs = gen.generate(emb, generator=seeded(2))
    print("generated images:", tuple(imgs.shape))

    # — 6. reconstruction metrics (against themselves here, to show them) —
    metrics = reconstruction_metrics(imgs, imgs)
    print("metrics:", metrics)

    # — 7. semantic-level captions (random tiny GIT weights here; convert
    #      git-large-coco and the trained PixelProjector for real ones) —
    gcfg = GITConfig.tiny()
    cap = GITCaptioner(gcfg).to(device).init_random(3)
    proj = PixelProjector(num_tokens=gcfg.num_visual_tokens, in_dim=64,
                          out_dim=gcfg.visual_dim).to(device).init_random(4)
    vocab = ["[PAD]", "[CLS]", "[SEP]", "[UNK]"] + [
        f"word{i}" for i in range(4, gcfg.vocab_size)]
    captions = caption_embeddings(cap, proj, gen_emb[:4],
                                  WordPieceTokenizer(vocab),
                                  max_new_tokens=6)
    print("captions:", captions)

    result = {"device": str(device), "retrieval": retrieval,
              "generated_retrieval": generated_retrieval,
              "prior_loss": pipe.last_steps["step_loss"].mean().item(),
              "images": list(imgs.shape),
              "image_range": [float(imgs.min()), float(imgs.max())],
              "metrics": metrics, "captions": captions}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
