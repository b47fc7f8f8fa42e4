"""Training of the shader network: config, optimizer, train and eval steps."""
