"""Training of the port: the fused GAN train step (``gan``), checkpoints
(``checkpoint``) and the GAN trainer CLI (``train_gan``); EMG-encoder
pre-training (``encoder``, its CLI) and its batching (``encoder_data``)."""
