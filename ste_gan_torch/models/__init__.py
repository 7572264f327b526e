"""Generator, discriminator ensemble and EMG encoder of the port."""
