"""Data-preparation, training and search recipes."""
from tdnnf_nas_torch.recipes.chain_recipes import (
    DataBundle, prepare_data, run_bottleneck_search_pipeline,
    run_offset_search_pipeline, train_model)
