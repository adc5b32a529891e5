"""The yardstick: cells, traffic, weights and data from the seed, the
arithmetic of every metric, the trace's reduction and the result line.
Nothing here changes with the program it measures."""
