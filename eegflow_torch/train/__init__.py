"""Training of the classifier (``eegflow.train`` counterpart), on one device
or over the ranks of a data mesh (:mod:`eegflow_torch.train.mesh`)."""

from eegflow_torch.train.mesh import (  # noqa: F401
    DataMesh,
    make_data_mesh,
    make_spmd_eval_step,
    make_spmd_train_step,
    replicate_to_mesh,
    shard_batch,
)
