from eeg_image_decode_tpu_torch.eval.recon_metrics import (  # noqa: F401
    pixcorr,
    ssim,
    two_way_identification,
    feature_distance,
    reconstruction_metrics,
)
from eeg_image_decode_tpu_torch.eval.backbones import (  # noqa: F401
    AlexNetFeatures,
    EfficientNetB1,
    InceptionV3,
    ResNet50,
    convert_alexnet,
    convert_efficientnet_b1,
    convert_inception_v3,
    convert_resnet50,
    make_imagenet_extractor,
)
