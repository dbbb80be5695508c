from repro_torch.data.synth import Dataset, DatasetSpec, SPECS, make_dataset, all_datasets
from repro_torch.data.lm_data import DataConfig, batch_at_step

__all__ = ["Dataset", "DatasetSpec", "SPECS", "make_dataset", "all_datasets",
           "DataConfig", "batch_at_step"]
