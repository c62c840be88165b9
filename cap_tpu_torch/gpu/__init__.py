"""The device engines: limbs, RNS arithmetic, RS*/ES* verify, kernels."""
