"""The port's examples — counterparts of the repo's `examples/` on
gmat_tpu_torch: `quickstart` (the three ways to use the toolkit),
`stills_and_torch` (the still codecs and tensors for PyTorch models) and
`avtoolkit_demos` (the metrans samples).  Each runs as
`python -m gmat_tpu_torch.examples.<name>`, on the card unless
`main(argv, device="cpu")` asks for the host, and writes under its
`--workdir`."""
