"""Signal-level image functionals of the port (``metrics_tpu/functional/image``)."""
from metrics_tpu_torch.functional.image.gradients import image_gradients
from metrics_tpu_torch.functional.image.ms_ssim import multiscale_structural_similarity_index_measure
from metrics_tpu_torch.functional.image.psnr import psnr
from metrics_tpu_torch.functional.image.ssim import ssim

__all__ = ["image_gradients", "multiscale_structural_similarity_index_measure", "psnr", "ssim"]
