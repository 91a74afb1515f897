from repro_torch.train.train_step import build_train_step, init_train_state
