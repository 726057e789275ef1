"""The data pipeline: dataset readers, host-side geometry, JPEG decode and
pixel transforms on the loader's device, and static-shape batching."""
