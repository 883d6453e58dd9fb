from repro_torch.data.pipeline import (DataConfig, TokenPipeline,
                                       make_batch_specs)

__all__ = ["DataConfig", "TokenPipeline", "make_batch_specs"]
