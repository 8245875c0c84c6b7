"""The master's speed and error monitors."""
