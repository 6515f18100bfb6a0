// Parity role: ref src/java/.../examples/SimpleInferClient.java —
// exits non-zero on mismatch.
package torch.client.examples;

import java.util.List;
import torch.client.InferInput;
import torch.client.InferRequestedOutput;
import torch.client.InferResult;
import torch.client.InferenceServerClient;

public final class SimpleInferClient {
  public static void main(String[] args) throws Exception {
    String url = args.length > 0 ? args[0] : "localhost:8000";
    try (InferenceServerClient client = new InferenceServerClient(url)) {
      if (!client.isServerLive()) {
        System.err.println("error: server not live");
        System.exit(1);
      }
      int[] a = new int[16];
      int[] b = new int[16];
      for (int i = 0; i < 16; i++) {
        a[i] = i;
        b[i] = 1;
      }
      InferInput i0 = new InferInput("INPUT0", new long[] {16},
                                     torch.client.DataType.INT32);
      i0.setData(a);
      InferInput i1 = new InferInput("INPUT1", new long[] {16},
                                     torch.client.DataType.INT32);
      i1.setData(b);
      InferResult result = client.infer(
          "add_sub", List.of(i0, i1),
          List.of(new InferRequestedOutput("OUTPUT0"),
                  new InferRequestedOutput("OUTPUT1")));
      int[] out0 = result.asIntArray("OUTPUT0");
      int[] out1 = result.asIntArray("OUTPUT1");
      for (int i = 0; i < 16; i++) {
        if (out0[i] != a[i] + b[i] || out1[i] != a[i] - b[i]) {
          System.err.println("error: incorrect result");
          System.exit(1);
        }
      }
      System.out.println("PASS : java infer");
    }
  }
}
