"""Online evaluation metrics and example images of the port (the exports of
``p2igan_tpu/metrics``)."""

from .metric import (  # noqa: F401
    MetricConfig,
    RainfallMetricSuite,
    categorical_metrics_compute,
    categorical_metrics_init,
    categorical_metrics_update,
    fss_compute,
    fss_init,
    fss_update,
    regression_metrics_compute,
    regression_metrics_init,
    regression_metrics_update,
    ssim_per_image,
    transform,
)
