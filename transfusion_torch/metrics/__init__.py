from transfusion_torch.metrics.sta_map import (
    STA_METRIC_NAMES,
    STA_METRIC_NAMES_NO_TTC,
    STAMeanAveragePrecision,
    STAMeanAveragePrecisionNoTTC,
)

__all__ = [
    "STAMeanAveragePrecision",
    "STAMeanAveragePrecisionNoTTC",
    "STA_METRIC_NAMES",
    "STA_METRIC_NAMES_NO_TTC",
]
