"""Phantoms and surrogates, the XCAT and CCTA pipelines, view selection,
the dataset builder and loader, volume I/O and the native projector."""
