"""Training of the classifier (``eegflow.train`` counterpart, one device,
no mesh)."""
