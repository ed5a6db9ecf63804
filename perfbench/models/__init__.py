"""Per family: a configuration file -> the program's model, and the
benchmark's weights in the layout the program serves from."""
