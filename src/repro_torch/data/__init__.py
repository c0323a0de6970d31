from repro_torch.data.images import SyntheticImages  # noqa
