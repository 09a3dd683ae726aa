"""The port's tools — counterparts of the repo's `tools/` scripts: the two
trainers of the bundled checkpoints (`train_sr`, `train_denoise`) and the
data-parallel scaling-shape artifact (`scaling_shape`).  Each runs as
`python -m gmat_tpu_torch.tools.<name>`, on the card unless asked for the
CPU."""
