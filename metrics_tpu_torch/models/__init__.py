"""Embedded models used by metric families (port of ``metrics_tpu/models``): FID's,
IS's and KID's InceptionV3, LPIPS's VGG16 and AlexNet backbones."""
from metrics_tpu_torch.models.inception import InceptionFeatureExtractor, InceptionV3
