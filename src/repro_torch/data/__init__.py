from repro_torch.data.synth import Dataset, DatasetSpec, SPECS, make_dataset, all_datasets

__all__ = ["Dataset", "DatasetSpec", "SPECS", "make_dataset", "all_datasets"]
