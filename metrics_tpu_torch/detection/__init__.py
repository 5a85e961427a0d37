from metrics_tpu_torch.detection.map import MAP, MeanAveragePrecision

__all__ = ["MAP", "MeanAveragePrecision"]
