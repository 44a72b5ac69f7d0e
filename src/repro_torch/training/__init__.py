"""Training of the port: AdamW, int8 gradient compression, the train
state and the train step."""
