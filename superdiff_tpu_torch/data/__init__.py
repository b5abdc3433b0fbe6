"""Image datasets with the reference's split DSL (numpy host pipeline)."""

from .datasets import (
    ImageDataset,
    PrefetchIterator,
    SplitSpec,
    get_image_inverse_scaler,
    get_image_scaler,
)

__all__ = ["ImageDataset", "PrefetchIterator", "SplitSpec", "get_image_scaler",
           "get_image_inverse_scaler"]
