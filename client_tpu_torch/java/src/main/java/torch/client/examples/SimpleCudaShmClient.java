// CUDA shared-memory inference: add_sub reads both inputs from a region
// that the caller made. Exits non-zero on mismatch.
//
//   java -cp out torch.client.examples.SimpleCudaShmClient \
//       localhost:8000 <rawHandleB64> [deviceId]
//
// The caller makes a region of 128 bytes, writes INPUT0 = 0..15 at
// offset 0 and INPUT1 = sixteen 1s at offset 64 (int32), and passes the
// base64 of its raw handle, e.g. with the port's Python module:
//   h = cuda_shared_memory.create_shared_memory_region("r", 128, 0)
//   cuda_shared_memory.set_shared_memory_region(h, [a, b])
//   base64.b64encode(cuda_shared_memory.get_raw_handle(h)).decode()
package torch.client.examples;

import java.util.List;
import torch.client.InferInput;
import torch.client.InferRequestedOutput;
import torch.client.InferResult;
import torch.client.InferenceServerClient;

public final class SimpleCudaShmClient {
  public static void main(String[] args) throws Exception {
    if (args.length < 2) {
      System.err.println(
          "usage: SimpleCudaShmClient <url> <rawHandleB64> [deviceId]");
      System.exit(2);
    }
    String url = args[0];
    String rawHandleB64 = args[1];
    int deviceId = args.length > 2 ? Integer.parseInt(args[2]) : 0;
    String region = "java_cudashm";
    try (InferenceServerClient client = new InferenceServerClient(url)) {
      client.registerCudaSharedMemory(region, rawHandleB64, deviceId, 128);
      try {
        InferInput i0 = new InferInput("INPUT0", new long[] {16},
                                       torch.client.DataType.INT32);
        i0.setSharedMemory(region, 64, 0);
        InferInput i1 = new InferInput("INPUT1", new long[] {16},
                                       torch.client.DataType.INT32);
        i1.setSharedMemory(region, 64, 64);
        InferResult result = client.infer(
            "add_sub", List.of(i0, i1),
            List.of(new InferRequestedOutput("OUTPUT0"),
                    new InferRequestedOutput("OUTPUT1")));
        int[] out0 = result.asIntArray("OUTPUT0");
        int[] out1 = result.asIntArray("OUTPUT1");
        for (int i = 0; i < 16; i++) {
          if (out0[i] != i + 1 || out1[i] != i - 1) {
            System.err.println("error: incorrect result");
            System.exit(1);
          }
        }
      } finally {
        client.unregisterCudaSharedMemory(region);
      }
      System.out.println("PASS : java cudashm infer");
    }
  }
}
