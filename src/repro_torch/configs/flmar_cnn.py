"""The paper's own client model: resolution-agnostic CNN standing in for the
modified YOLOv5m of §VII-B (see repro.models.cnn)."""
CONFIG = dict(
    name="flmar-cnn",
    num_classes=8,
    widths=(16, 32, 64),
    base_resolution=32,
    dataset_resolutions=(8, 16, 24, 32),
    source="paper §VII-B / arXiv:2209 (this paper)",
)
