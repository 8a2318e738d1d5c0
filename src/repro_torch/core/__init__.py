"""Framework-free core of the port: the location-aware store, the serving
config and the prefetch engine (copied from the reference's ``core``; the
scheduler, simulator, compiler and topology come with a later slice)."""
