"""Framework-free helpers of the port: device resolution, the config tree
with its ``--section.key=value`` overrides, and the FLOPs/MFU accounting."""
