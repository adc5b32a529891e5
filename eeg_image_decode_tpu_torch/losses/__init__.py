from eeg_image_decode_tpu_torch.losses.clip_loss import (
    clip_loss,
    clip_loss_distributed,
    reconstruction_loss,
    retrieval_loss,
    symmetric_infonce,
)

__all__ = ["clip_loss", "clip_loss_distributed", "reconstruction_loss",
           "retrieval_loss", "symmetric_infonce"]
