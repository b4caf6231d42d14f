"""Model layer of the port: the dense GQA decoder's decode and training paths."""
