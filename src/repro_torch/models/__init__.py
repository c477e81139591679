"""Model zoo of the port: layers and the block program."""
