"""The plain reference: the two RenderNet networks, their losses, the
multipass warp and Adam in float32 PyTorch with TF32 off. It imports
nothing of ``rendernet_tpu_torch`` (nor JAX) and takes nothing the program
made: weights come from ``portbench.weights``, inputs from
``portbench.traffic``."""
