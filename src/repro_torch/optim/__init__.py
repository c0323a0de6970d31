from repro_torch.optim.adamw import adamw_init, adamw_update, clip_by_global_norm  # noqa
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa
