"""The plain reference: a regex parser, a Thompson automaton and a
bit-packed multi-source product BFS in numpy, with the paper's §4.2 cost
meters per start.  It imports nothing of the port."""
