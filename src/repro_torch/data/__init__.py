"""The data pipeline (``pipeline.py``): a copy of the JAX package's."""
from .pipeline import DataConfig, DataPipeline, PipelineState, TokenStream, build_token_file

__all__ = ["DataConfig", "DataPipeline", "PipelineState", "TokenStream", "build_token_file"]
