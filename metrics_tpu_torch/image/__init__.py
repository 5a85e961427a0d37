"""Image metrics of the port (``metrics_tpu/image``): PSNR, SSIM, MS-SSIM,
and FID, KID, IS and LPIPS on their embedded models (``metrics_tpu_torch/models``)."""
from metrics_tpu_torch.image.fid import FID, FrechetInceptionDistance
from metrics_tpu_torch.image.inception import IS, InceptionScore
from metrics_tpu_torch.image.kid import KID, KernelInceptionDistance
from metrics_tpu_torch.image.lpip_similarity import LPIPS
from metrics_tpu_torch.image.psnr import PSNR
from metrics_tpu_torch.image.ssim import SSIM, MultiScaleStructuralSimilarityIndexMeasure

__all__ = ["FID", "FrechetInceptionDistance", "IS", "InceptionScore", "KID", "KernelInceptionDistance", "LPIPS",
           "MultiScaleStructuralSimilarityIndexMeasure", "PSNR", "SSIM"]
