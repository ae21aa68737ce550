"""Worker entry points: the LM runner and the JAXJob runner."""
