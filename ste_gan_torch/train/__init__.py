"""GAN training of the port: the fused train step (``gan``), checkpoints
(``checkpoint``) and the trainer CLI (``train_gan``)."""
