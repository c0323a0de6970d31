from repro_torch.data.tokens import TokenStream  # noqa
from repro_torch.data.images import SyntheticImages  # noqa
