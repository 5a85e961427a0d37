"""Signal-level image metrics of the port (``metrics_tpu/image``): PSNR, SSIM
and MS-SSIM. FID, KID, IS and LPIPS are not ported yet."""
from metrics_tpu_torch.image.psnr import PSNR
from metrics_tpu_torch.image.ssim import SSIM, MultiScaleStructuralSimilarityIndexMeasure

__all__ = ["MultiScaleStructuralSimilarityIndexMeasure", "PSNR", "SSIM"]
