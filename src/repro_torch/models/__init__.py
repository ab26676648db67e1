from repro_torch.models.model_zoo import (ModelAPI, get_model,  # noqa: F401
                                          input_specs, make_batch)
