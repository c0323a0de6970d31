from repro_torch.checkpoint.io import latest_step, restore_checkpoint, save_checkpoint  # noqa
