"""Training of the port: so far the cross-pod gradient sync of the train step."""
