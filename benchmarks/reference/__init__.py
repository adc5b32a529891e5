"""Plain float32 references of what the cells run. They import nothing of
the program, take nothing it made, and are run after the window."""
