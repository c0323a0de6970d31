"""Framework-free planning layer and the emulated engine of the port."""
