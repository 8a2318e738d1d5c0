"""Training: AdamW, the train step, checkpoints, the loop and elastic
restore onto a new mesh (the port of ``repro.train``)."""
