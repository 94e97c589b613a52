"""The community service's pieces that the port has so far: the size
buckets and the dense-vs-sortscan crossover (``service/buckets.py``)."""
from repro_torch.service.buckets import (
    DEFAULT_BUCKETS, DEFAULT_DENSE_MIN_DENSITY, Bucket,
    calibrated_min_density, choose_bucket, choose_scan,
)

__all__ = [
    "Bucket",
    "DEFAULT_BUCKETS",
    "DEFAULT_DENSE_MIN_DENSITY",
    "calibrated_min_density",
    "choose_bucket",
    "choose_scan",
]
