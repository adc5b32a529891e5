"""One driver a kind of configuration, named by the configuration file's
``driver`` key: it builds the program, runs the warm-up, the window and
the check against the reference."""
