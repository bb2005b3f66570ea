"""One train step of the CycleGAN: state, gradients and Adam updates."""
