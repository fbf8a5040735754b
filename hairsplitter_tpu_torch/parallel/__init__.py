"""Runs over several processes (`distributed`) and over a list of devices
(`mesh`): counterparts of `hairsplitter_tpu/parallel/`."""
