"""Framework exceptions (port of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsTPUUserError(Exception):
    """Error raised on illegal use of the metric runtime (protocol violations)."""


# Short public alias used throughout the package.
UserError = MetricsTPUUserError
