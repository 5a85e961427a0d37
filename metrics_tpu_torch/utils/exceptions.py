"""Framework exceptions (port of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsTPUUserError(Exception):
    """Error raised on illegal use of the metric runtime (protocol violations)."""


class NotPortedError(MetricsTPUUserError):
    """A feature of the JAX package that the port does not have yet (ROADMAP.md §A)."""


class KernelBackendError(MetricsTPUUserError):
    """A kernel backend name whose choice the port makes by device: a CUDA
    tensor takes the hand-written kernel, a CPU tensor its plain version."""


# Short public alias used throughout the package.
UserError = MetricsTPUUserError
