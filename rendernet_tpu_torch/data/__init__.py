"""Host-side data pipeline: pose parsing, tar-streaming loaders, prefetch,
synthetic datasets."""
