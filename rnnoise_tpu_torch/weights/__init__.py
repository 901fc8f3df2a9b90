"""DNNw weight blobs: parse, write, densify, and torch model params."""
