"""Configuration of the port (copy of ``eeg_image_decode_tpu/core/config.py``).

The dataclasses the ported slices need are copied: ``DataConfig``,
``ATMSConfig``, ``ContrastiveTrainConfig``, ``PriorConfig`` and
``LowLevelConfig``. Defaults reproduce the reference's hyperparameters.

The three ``fused_*`` switches name a hand-written CUDA kernel of
``ops/``: ``True`` routes through the kernel's wrapper (the kernel for a
CUDA tensor, its plain PyTorch version for a CPU tensor), ``False`` takes
the plain module path, and ``'auto'`` means "the kernel when the tensor is
on CUDA" — except ``fused_projection``, whose ``'auto'`` keeps the exact-erf
plain head exactly as the JAX package's does.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass(frozen=True)
class DataConfig:
    """THINGS-EEG dataset layout (ref ``Retrieval/eegdatasets_leaveone.py``)."""

    data_path: str = ""
    img_directory_training: str = ""
    img_directory_test: str = ""
    #: training set: 1654 classes x 10 images x 4 EEG repetitions
    n_train_classes: int = 1654
    images_per_train_class: int = 10
    train_reps: int = 4
    #: test set: 200 classes x 1 image x 80 repetitions (averaged by default)
    n_test_classes: int = 200
    test_reps: int = 80
    average_test_reps: bool = True
    n_channels: int = 63
    n_timepoints: int = 250
    time_window: tuple[float, float] = (0.0, 1.0)
    #: clip-space embedding width (OpenCLIP ViT-H/14)
    clip_dim: int = 1024
    normalize_img_features: bool = True
    text_prompt_template: str = "This picture is {description}"

    @classmethod
    def from_json(cls, path: str) -> "DataConfig":
        """Load the reference's ``data_config.json`` path file."""
        with open(path) as f:
            raw = json.load(f)
        return cls(
            data_path=raw.get("data_path", ""),
            img_directory_training=raw.get("img_directory_training", ""),
            img_directory_test=raw.get("img_directory_test", ""),
        )


@dataclass(frozen=True)
class ATMSConfig:
    """ATM-S flagship encoder (ref ``Retrieval/ATMS_retrieval.py:44-59,171-191``).

    Channel-token iTransformer: each of the 63 EEG channels becomes a token of
    its 250-sample time course; a subject token is prepended; one post-norm
    attention layer mixes channels; a ShallowNet-style temporal-spatial conv
    stack plus a projector maps to the 1024-d CLIP space.
    """

    n_channels: int = 63
    seq_len: int = 250
    d_model: int = 250
    n_heads: int = 4
    n_layers: int = 1
    d_ff: int = 256
    dropout: float = 0.25
    num_subjects: int = 10
    #: per-subject value embeddings (joint training, ref ``Embed.py:127-130``)
    joint_train: bool = False
    # tsconv stage (ref ``ATMS_retrieval.py:97-125``)
    conv_filters: int = 40
    temporal_kernel: int = 25
    pool_size: int = 51
    pool_stride: int = 5
    conv_dropout: float = 0.5
    emb_size: int = 40
    proj_dim: int = 1024
    proj_dropout: float = 0.5
    #: exact-erf GELU in the attention FFN (the reference's ``F.gelu``);
    #: the kernel computes tanh GELU, so True forces the plain layer
    exact_gelu: bool = False
    #: CUDA attention-layer kernel (ops/attention.py)
    fused_attention: bool | str = "auto"
    #: CUDA tsconv stage-1 kernel (ops/tsconv.py)
    fused_tsconv: bool | str = "auto"
    #: stage-1 BatchNorm: 'gram' takes the batch statistics from the
    #: stage-1 product's inputs (models/layers.py::GramStage1BN), as JAX's
    #: default does; 'gram2d' / 'gramfold' put its affine in the tsconv
    #: kernel's fp32 epilogue. Active on the fused path only (a CUDA input
    #: under 'auto'): 'flax' elsewhere and on demand
    tsconv_bn1: str = "gram"
    #: CUDA projection-head kernel (ops/projection.py); 'auto' keeps the
    #: plain exact-erf head, as in the JAX package
    fused_projection: bool | str = "auto"


@dataclass(frozen=True)
class ContrastiveTrainConfig:
    """Contrastive retrieval training (ref ``Retrieval/ATMS_retrieval.py:516-586``).

    ``host_dtype`` is the streaming trainer's host copy of the EEG
    (``None``: float32; ``"bfloat16"``: half the bytes a batch); the
    resident trainer ignores it. The JAX config's ``data_axis`` names the
    mesh's batch axis, which is always ``dp`` here (``core/mesh.py``). Its
    ``encoder``,
    ``compute_dtype`` and ``logit_scale_init`` belong to the model here:
    the trainer takes a ``build_encoder`` model, named by its first
    argument, computing in its ``dtype=`` (``torch.bfloat16`` for the JAX
    default's bf16 compute) and holding its logit scale (init ln(1/0.07))."""

    batch_size: int = 1024
    epochs: int = 40
    lr: float = 3e-4
    weight_decay: float = 1e-2  # AdamW default (torch), applied decoupled
    #: loss = alpha*img_clip + (1-alpha)*text_clip (ref ``:206,234``)
    alpha: float = 0.99
    #: reconstruction variant: alpha*MSE*10 + (1-alpha)*img_clip*10
    #: (ref ``Generation/ATMS_reconstruction.py:198,227-228``)
    recon_loss: bool = False
    recon_alpha: float = 0.90
    seed: int = 0
    eval_ks: tuple[int, ...] = (2, 4, 10, 50, 100, 200)
    #: with a checkpointer: save every this many epochs (ref ``:381``), and
    #: always after the last
    ckpt_every_epochs: int = 5
    #: streaming: the dtype of the host copy of the EEG (None | "bfloat16")
    host_dtype: str | None = None


@dataclass(frozen=True)
class PriorConfig:
    """Diffusion prior (ref ``Generation/diffusion_prior.py:92-203,268-338``)."""

    embed_dim: int = 1024
    cond_dim: int = 1024
    hidden_dims: tuple[int, ...] = (1024, 512, 256, 128, 64)
    time_embed_dim: int = 512
    dropout: float = 0.0
    # training
    num_train_timesteps: int = 1000
    batch_size: int = 1024
    epochs: int = 150
    lr: float = 1e-3
    warmup_steps: int = 500
    grad_clip_norm: float = 1.0
    cond_dropout_prob: float = 0.1
    # sampling
    num_inference_steps: int = 50
    guidance_scale: float = 5.0
    seed: int = 0

    @staticmethod
    def tiny() -> "PriorConfig":
        """Dims matched to the tiny SDXL UNet's 64-d image embeds (the CLI's
        ``--tiny`` smoke chain, prior → generator)."""
        return PriorConfig(
            embed_dim=64, cond_dim=64, hidden_dims=(64, 32),
            time_embed_dim=32, batch_size=8, epochs=2, warmup_steps=2,
            num_inference_steps=4,
        )


@dataclass(frozen=True)
class LowLevelConfig:
    """VAE-latent low-level encoder training
    (ref ``Generation/train_vae_latent_512_low_level_no_average.py:219-260,490-545``)."""

    n_channels: int = 63
    seq_len: int = 250
    time_proj_dim: int = 128
    latent_shape: tuple[int, int, int] = (4, 64, 64)
    batch_size: int = 30
    epochs: int = 200
    lr: float = 1e-3
