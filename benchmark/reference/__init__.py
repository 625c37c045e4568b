"""The plain float32 reference: model, post-processing, loss and optimizer, in
plain PyTorch; it imports nothing of the program."""
