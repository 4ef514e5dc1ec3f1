"""The training data pipelines (host copies of ``repro.data``)."""

from .pipeline import FileTokenData, SyntheticLMData, make_pipeline  # noqa: F401
