"""The plain reference: the cross-modal UDA task in plain PyTorch, fp32,
with TF32 off.  It imports nothing of the measured program, works the
topology out again from the raw inputs, and only reads the program's
outputs to judge them."""
