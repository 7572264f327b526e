"""The benchmark's plain reference: STE-GAN's networks, losses, optimizer
and training steps in plain PyTorch, written from the published model's
equations. It imports nothing of the program under test, so it can judge
the program's outputs."""
