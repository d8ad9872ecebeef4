from ray_tpu_torch.rllib.train import main

raise SystemExit(main())
