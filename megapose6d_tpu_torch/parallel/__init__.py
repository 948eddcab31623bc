"""Several devices: process groups and collectives (`distributed`), and a
device list that one process splits a batch over (`mesh`)."""
